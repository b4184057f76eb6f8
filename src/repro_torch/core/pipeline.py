"""Algorithm 2: per-class generator construction -> (FT) -> linear SVM.

Counterpart of ``src/repro/core/pipeline.py``.  ``method`` is any spec of
:mod:`repro_torch.api`: an OAVI variant (``"fast"``, ``"oavi:cgavi-ihb"``,
...) or one of the paper's baselines ``"abm"`` and ``"vca"``.  The per-class
fits run through :func:`repro_torch.api.fit_classes`: class-batched under
``class_batch="auto"`` (the default, as in the reference) where the config
allows, one class after another otherwise; the features come from :func:`repro_torch.api.feature_transform` (fused for OAVI
and ABM models, the per-model loop for VCA), and the l1 squared-hinge
:class:`~repro_torch.core.svm.LinearSVM` classifies them.  Everything runs
on ``device`` (``None`` = the CUDA card).  :meth:`~VanishingIdealClassifier.
average_degree` and :meth:`~VanishingIdealClassifier.sparsity` are Table 3's
columns.

A fitted pipeline serializes whole (scaler, per-class models, SVM head) in
the JAX package's layout and format (``to_state_dict`` / ``save`` /
``load``), so either package loads the other's classifiers.

``chunk_rows`` streams each per-class OAVI fit out-of-core
(:mod:`repro_torch.streaming`), and ``capture_fit_state`` also keeps each
class's :class:`repro_torch.online.FitState` on ``clf.fit_states`` for
:func:`repro_torch.api.update`.  :meth:`~VanishingIdealClassifier.
attach_engine` routes ``transform`` / ``predict`` through a warmed
:class:`repro_torch.serving.TransformEngine` on the classifier's device.

Algorithm 2's phases are :mod:`repro_torch.obs` spans, nested by time:
``pipeline/fit`` (``fit=<n>``, a per-process count) holds
``pipeline/generators`` (``pipeline/scale``: the scaler and the class
split; then the class fits' ``fit`` spans), ``pipeline/transform`` and
``svm/fit`` (``LinearSVM.fit``'s own spans inside); ``pipeline/predict``
(``fit=<n>`` of the fit it predicts with) holds ``pipeline/transform`` and
``svm/decision``, the host's argmax over ``X @ W + b``.  ``stats``'s
``time_generators``, ``time_transform`` and ``time_svm`` are the durations
of ``pipeline/generators``, ``pipeline/transform`` and ``svm/fit``, and
``time_total`` that of ``pipeline/fit``, with tracing on or off.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import _device, obs
from .svm import LinearSVM, LinearSVMConfig
from .transform import MinMaxScaler

CLASSIFIER_FORMAT = "repro.vanishing_ideal_classifier.v1"

# the ``fit=<n>`` of the pipeline spans: the spans of one fit share it
_FIT_COUNT = itertools.count(1)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The reference's ``PipelineConfig``: ``backend="sharded"`` (or
    ``"auto"`` with a ``mesh``) fits the per-class generators data-parallel
    over the ``DeviceMesh`` (:mod:`repro_torch.core.distributed`)."""

    method: str = "fast"  # repro_torch.api method spec (or bare OAVI variant)
    psi: float = 0.005
    svm: LinearSVMConfig = dataclasses.field(default_factory=LinearSVMConfig)
    oavi_kw: Optional[Dict] = None  # forwarded to the method config
    backend: str = "auto"  # repro_torch.api backend: 'auto' | 'local' | 'sharded'
    mesh: Optional[Any] = None  # torch DeviceMesh for the sharded backend
    batch_size: Optional[int] = None  # fused-transform chunking (rows)
    # 'auto': eligible per-class OAVI fits run class-batched, grouped into
    # shared row buckets (repro_torch.core.class_batch); 'off': sequential
    class_batch: str = "auto"
    # out-of-core generator construction: each per-class OAVI fit streams in
    # chunk_rows-row chunks (repro_torch.streaming; bit for bit the in-memory
    # fit at matched capacity).  None: in-memory fits.
    chunk_rows: Optional[int] = None
    # keep each class's repro_torch.online.FitState (clf.fit_states, class
    # order) for repro_torch.api.update; needs chunk_rows and an OAVI method,
    # and fits the classes one after another (states are per class)
    capture_fit_state: bool = False


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
        self.engine = None  # optional serving TransformEngine (attach_engine)
        self.fit_states: List = []  # per-class FitState (capture_fit_state)
        self.fit_id: Optional[int] = None  # the spans' fit=<n> of the last fit

    def _fit_generator_models(self, Xcs) -> List:
        """Per-class generator construction through
        :func:`repro_torch.api.fit_classes`, or one streamed fit per class
        that keeps its :class:`~repro_torch.online.FitState`."""
        from .. import api

        cfg = self.config
        self.fit_states = []
        kw = dict(method=cfg.method, psi=cfg.psi, backend=cfg.backend, mesh=cfg.mesh,
                  chunk_rows=cfg.chunk_rows, device=self.device, **dict(cfg.oavi_kw or {}))
        if not cfg.capture_fit_state:
            return api.fit_classes(Xcs, class_batch=cfg.class_batch, **kw)
        if cfg.chunk_rows is None:
            raise ValueError(
                "capture_fit_state=True requires chunk_rows (the streaming "
                "fit path persists the Gram accumulators)"
            )
        models = [api.fit(Xc, capture_state=True, **kw) for Xc in Xcs]
        self.fit_states = [m.fit_state for m in models]
        return models

    def _feature_transform(self, X) -> np.ndarray:
        from .. import api

        engine = self.engine
        if engine is not None and not engine.matches(self.models):
            engine = None  # the models were refitted since attach_engine
        return api.feature_transform(
            self.models, X, batch_size=self.config.batch_size, dtype=self.dtype,
            device=self.device, engine=engine,
        )

    def attach_engine(self, engine=None, *, engine_config=None, warmup: bool = True,
                      mesh=None):
        """Route ``transform`` / ``predict`` through a serving
        :class:`~repro_torch.serving.engine.TransformEngine` on the
        classifier's device (row buckets warmed before traffic).

        Builds one over ``self.models`` when ``engine`` is omitted, sharded
        over ``mesh`` (a sequence of devices) when given.  Model sets
        without a fused term-book plan (VCA) keep the per-model path: the
        engine stays ``None`` and ``None`` is returned.
        """
        from ..serving.engine import EngineConfig, TransformEngine, UnsupportedModelError

        if engine is None:
            try:
                engine = TransformEngine(self.models, device=self.device, mesh=mesh,
                                         config=engine_config or EngineConfig())
            except UnsupportedModelError:
                self.engine = None
                return None
        elif not engine.matches(self.models):
            raise ValueError("engine was built for a different model set")
        if warmup:
            engine.warmup()  # idempotent: warmed buckets are skipped
        self.engine = engine
        return engine

    def head(self, feats) -> np.ndarray:
        """Classifier head over precomputed (FT) features: SVM argmax (the
        per-request tail of ``predict`` the serving batcher applies after
        the coalesced transform)."""
        return self.svm.predict(np.asarray(feats))

    def fit(self, X, y) -> "VanishingIdealClassifier":
        from .. import api

        self.fit_id = next(_FIT_COUNT)
        with obs.timed("pipeline/fit", fit=self.fit_id) as t_fit:
            with obs.timed("pipeline/generators") as t_gen:
                with obs.span("pipeline/scale"):
                    X = self.scaler.fit_transform(X)
                    y = np.asarray(y)
                    self.classes_ = np.unique(y)
                    Xcs = [X[y == c] for c in self.classes_]
                self.models = self._fit_generator_models(Xcs)
            with obs.timed("pipeline/transform") as t_transform:
                Xt = self._feature_transform(X)
            with obs.timed("svm/fit") as t_svm:
                self.svm.fit(Xt, y)
            agg = api.aggregate_fit_stats(self.models)
        self.stats = {
            "time_generators": t_gen.duration_s,
            "time_transform": t_transform.duration_s,
            "time_svm": t_svm.duration_s,
            "time_total": t_fit.duration_s,
            "num_features": Xt.shape[1],
            "G_plus_O": sum(m.stats.get("G_plus_O", 0) for m in self.models),
            "regrowths": agg["regrowths"],
            "kernel_launches": agg["kernel_launches"],
            "class_batched": agg["class_batched"],
            "solver_schedule_len": agg["solver_schedule_len"],
            "solver_escalations": agg["solver_escalations"],
            "per_class": [m.stats for m in self.models],
            "svm": self.svm.stats,
        }
        if "class_batch_padding" in agg:
            self.stats["class_batch_padding"] = agg["class_batch_padding"]
        return self

    def transform(self, X) -> np.ndarray:
        with obs.span("pipeline/transform"):
            return self._feature_transform(self.scaler.transform(X))

    def predict(self, X) -> np.ndarray:
        with obs.span("pipeline/predict", fit=self.fit_id):
            feats = self.transform(X)
            with obs.span("svm/decision"):
                return self.svm.predict(feats)

    def score(self, X, y) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y)))

    # -- reporting helpers (Table 3 quantities) ---------------------------

    def average_degree(self) -> float:
        """Mean degree of the generators' leading terms (models with a term
        book: OAVI and ABM)."""
        degs = []
        for model in self.models:
            gens = getattr(model, "generators", None)
            if gens is not None:
                degs += [sum(g.term) for g in gens]
        return float(np.mean(degs)) if degs else 0.0

    def sparsity(self) -> float:
        """(SPAR): fraction of zero non-leading coefficients over all G."""
        z = e = 0
        for model in self.models:
            gens = getattr(model, "generators", None)
            if gens is None:
                continue
            for g in gens:
                e += len(g.coeffs)
                z += int(np.sum(g.coeffs == 0.0))
        return z / e if e else 0.0

    # -- serialization ----------------------------------------------------

    def to_state_dict(self) -> Tuple[Dict[str, np.ndarray], Dict]:
        """Flat array tree + JSON-safe metadata for the whole pipeline, in
        the JAX package's layout: ``model_###.`` prefixed per-class model
        arrays, ``scaler_lo``, ``scaler_scale``, ``svm_W``, ``svm_b`` and
        ``classes``."""
        from .. import api

        if self.svm.W is None or self.classes_ is None:
            raise ValueError("cannot serialize an unfitted classifier")
        arrays: Dict[str, np.ndarray] = {}
        model_metas = []
        for i, model in enumerate(self.models):
            a, meta = model.to_state_dict()
            api._model_class(meta.get("kind"))
            for k, v in a.items():
                arrays[f"model_{i:03d}.{k}"] = v
            model_metas.append(meta)
        arrays["scaler_lo"] = np.asarray(self.scaler.lo)
        arrays["scaler_scale"] = np.asarray(self.scaler.scale)
        arrays["svm_W"] = np.asarray(self.svm.W)
        arrays["svm_b"] = np.asarray(self.svm.b)
        arrays["classes"] = np.asarray(self.classes_)
        cfg = self.config
        meta = {
            "kind": "classifier",
            "num_models": len(self.models),
            "models": model_metas,
            "dtype": self.dtype,
            "config": {
                "method": cfg.method,
                "psi": cfg.psi,
                "svm": dataclasses.asdict(cfg.svm),
                "oavi_kw": cfg.oavi_kw,
                "backend": cfg.backend,
                "batch_size": cfg.batch_size,
                "class_batch": cfg.class_batch,
                "chunk_rows": cfg.chunk_rows,
                "capture_fit_state": cfg.capture_fit_state,
            },
            "svm_stats": self.svm.stats,
            "stats": self.stats,
        }
        return arrays, meta

    @classmethod
    def from_state_dict(cls, arrays: Dict[str, np.ndarray], meta: Dict,
                        device=None) -> "VanishingIdealClassifier":
        """Rebuild a classifier from :meth:`to_state_dict` output (also the
        JAX package's) on ``device`` (``None`` = the CUDA card)."""
        from .. import api

        if meta.get("kind") != "classifier":
            raise ValueError(f"expected a classifier, got kind {meta.get('kind')!r}")
        cfg = meta["config"]
        clf = cls(
            PipelineConfig(
                method=cfg["method"],
                psi=cfg["psi"],
                svm=LinearSVMConfig(**cfg["svm"]),
                oavi_kw=cfg["oavi_kw"],
                backend=cfg.get("backend", "auto"),
                batch_size=cfg["batch_size"],
                # saves that lack the key fitted with the default, 'auto'
                class_batch=cfg.get("class_batch", "auto"),
                # saves that lack the keys fitted in memory
                chunk_rows=cfg.get("chunk_rows"),
                capture_fit_state=cfg.get("capture_fit_state", False),
            ),
            device=device,
        )
        clf.scaler.lo = np.asarray(arrays["scaler_lo"])
        clf.scaler.scale = np.asarray(arrays["scaler_scale"])
        clf.models = []
        for i, model_meta in enumerate(meta["models"]):
            prefix = f"model_{i:03d}."
            sub = {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}
            model_cls = api._model_class(model_meta.get("kind"))
            clf.models.append(model_cls.from_state_dict(sub, model_meta, device=clf.device))
        clf.svm.W = np.asarray(arrays["svm_W"])
        clf.svm.b = np.asarray(arrays["svm_b"])
        clf.svm.classes_ = np.asarray(arrays["classes"])
        clf.svm.stats = dict(meta.get("svm_stats") or {})
        clf.classes_ = np.asarray(arrays["classes"])
        clf.stats = dict(meta.get("stats") or {})
        return clf

    def save(self, path: str) -> str:
        """Persist the fitted pipeline to ``path`` (a directory) atomically,
        in the layout of :func:`repro_torch.api.save` with format
        :data:`CLASSIFIER_FORMAT`."""
        from .. import api

        arrays, meta = self.to_state_dict()
        return api.save_state_dict(path, arrays, meta, CLASSIFIER_FORMAT)

    @classmethod
    def load(cls, path: str, *, device=None) -> "VanishingIdealClassifier":
        """Load a pipeline written by :meth:`save` (by either package) onto
        ``device`` (``None`` = the CUDA card); the port's own round trip
        predicts bit-identically."""
        from .. import api

        arrays, metadata = api.load_state_dict(path, CLASSIFIER_FORMAT)
        return cls.from_state_dict(arrays, metadata["meta"], device=device)
