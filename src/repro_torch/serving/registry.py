"""ModelRegistry: versioned, warmed, hot-swappable serving entries.

Counterpart of ``src/repro/serving/registry.py``, on one explicit device
(``device=None``: the CUDA card; ``"cpu"`` only when asked): servables are
loaded onto it and their engines evaluate there.  With ``mesh=`` (a
sequence of devices) every engine is sharded over them
(:class:`~repro_torch.serving.engine.TransformEngine`) and servables load
onto the first.

A serving process holds one registry.  Each ``register``/``load`` call
builds a :class:`~repro_torch.serving.engine.TransformEngine` for the servable's
model set (and warms its shape buckets so live traffic never compiles),
then files it under ``(name, version)``.  ``activate`` flips the active
version pointer atomically — hot-swap: in-flight requests finish on the old
engine object, new requests resolve the new one.

Servables come from checkpoint paths written by either package's
``api.save`` (a single :class:`VanishingIdealModel`) or
``VanishingIdealClassifier.save`` (scaler + per-class models + SVM head),
read through the port's :mod:`repro_torch.checkpoint.store`;
:func:`load_servable` dispatches on the manifest format tag.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .. import _device
from ..checkpoint import store as ckpt_store
from ..resilience import chaos
from .engine import EngineConfig, TransformEngine, UnsupportedModelError, mesh_devices


def load_servable(path: str, *, device=None):
    """Load whatever committed checkpoint lives at ``path`` onto ``device``
    (``None``: the CUDA card): a :class:`VanishingIdealModel` (``api.save``)
    or a :class:`VanishingIdealClassifier` (``classifier.save``), written
    by either package."""
    from .. import api
    from ..core import pipeline

    metadata, _ = ckpt_store.read_metadata(path)
    fmt = metadata.get("format")
    if fmt == api._FORMAT:
        return api.load(path, device=device)
    if fmt == pipeline.CLASSIFIER_FORMAT:
        return pipeline.VanishingIdealClassifier.load(path, device=device)
    raise ValueError(f"{path!r} has unknown checkpoint format {fmt!r}")


@dataclasses.dataclass
class RegistryEntry:
    """One servable version: the loaded object, its warmed engine, and the
    request-path helpers the launcher / batcher need."""

    name: str
    version: int
    servable: object  # VanishingIdealModel or VanishingIdealClassifier
    models: Tuple  # the engine's model set
    engine: Optional[TransformEngine]  # None -> per-model fallback (VCA)
    head: Optional[Callable[[np.ndarray], np.ndarray]]  # features -> labels
    scaler: Optional[object]  # MinMaxScaler for raw request inputs
    path: Optional[str]
    loaded_at: float
    ever_activated: bool = False  # has this version ever carried traffic?

    @property
    def num_features(self) -> int:
        if self.engine is not None:
            return self.engine.consts.num_features
        return sum(m.num_G for m in self.models)

    def scale(self, Z) -> np.ndarray:
        """Raw request rows -> the [0,1]^n inputs the models were fitted on
        (identity for model-only entries, which carry no scaler)."""
        return Z if self.scaler is None else self.scaler.transform(Z)

    def transform(self, Z, *, scaled: bool = False) -> np.ndarray:
        """(FT) features through the warmed engine (or the per-model
        fallback when the model set has no fused plan)."""
        from .. import api

        Z = np.asarray(Z)
        if not scaled:
            Z = self.scale(Z)
        if self.engine is not None:
            return self.engine.transform(Z)
        return api.feature_transform(list(self.models), Z)

    def predict(self, Z, *, scaled: bool = False) -> np.ndarray:
        if self.head is None:
            raise ValueError(
                f"{self.name!r} v{self.version} is a bare model set; predict "
                "needs a classifier servable (with an SVM head)"
            )
        return self.head(self.transform(Z, scaled=scaled))


class ModelRegistry:
    """Thread-safe (name, version) -> warmed engine store with hot-swap."""

    def __init__(
        self,
        *,
        device=None,
        mesh=None,
        engine_config: EngineConfig = EngineConfig(),
        warmup: bool = True,
        warmup_rows: Optional[int] = None,
    ):
        self.mesh = None if mesh is None else mesh_devices(mesh)
        self.device = self.mesh[0] if self.mesh else _device.resolve(device)
        self.engine_config = engine_config
        self.warmup = warmup
        self.warmup_rows = warmup_rows
        self._entries: Dict[str, Dict[int, RegistryEntry]] = {}
        self._active: Dict[str, int] = {}
        self._lock = threading.Lock()

    # -- registration ------------------------------------------------------

    def _model_set(self, servable) -> Tuple[Tuple, Optional[Callable], Optional[object]]:
        models = getattr(servable, "models", None)
        if models is not None:  # classifier: per-class models + head + scaler
            return tuple(models), servable.head, getattr(servable, "scaler", None)
        return (servable,), None, None

    def register(
        self,
        name: str,
        servable,
        *,
        version: Optional[int] = None,
        activate: bool = True,
        path: Optional[str] = None,
    ) -> RegistryEntry:
        """File ``servable`` under ``(name, version)`` with a warmed engine.

        ``version`` defaults to one past the newest registered version.
        ``activate=False`` stages the version without flipping traffic to it
        (finish warmup, run shadow checks, then :meth:`activate`).
        """
        if version is not None:
            with self._lock:  # cheap duplicate check BEFORE paying warmup
                if version in self._entries.get(name, {}):
                    raise ValueError(f"{name!r} v{version} is already registered")
        models, head, scaler = self._model_set(servable)
        try:
            engine = TransformEngine(models, device=self.device, mesh=self.mesh,
                                     config=self.engine_config)
            if self.warmup:
                engine.warmup(self.warmup_rows)
        except UnsupportedModelError:
            engine = None  # VCA & co: per-model fallback path
        with self._lock:
            versions = self._entries.setdefault(name, {})
            if version is None:
                version = max(versions, default=0) + 1
            if version in versions:
                raise ValueError(f"{name!r} v{version} is already registered")
            entry = RegistryEntry(
                name=name,
                version=version,
                servable=servable,
                models=models,
                engine=engine,
                head=head,
                scaler=scaler,
                path=path,
                loaded_at=time.time(),
                ever_activated=activate,
            )
            versions[version] = entry
            if activate:
                self._active[name] = version
        return entry

    def load(self, name: str, path: str, **register_kw) -> RegistryEntry:
        """:func:`load_servable` onto the registry's device + :meth:`register`
        in one step."""
        return self.register(name, load_servable(path, device=self.device), path=path,
                             **register_kw)

    # -- lookup / hot-swap -------------------------------------------------

    def get(self, name: str, version: Optional[int] = None) -> RegistryEntry:
        with self._lock:
            versions = self._entries.get(name)
            if not versions:
                raise KeyError(f"no servable registered under {name!r}")
            if version is None:
                version = self._active.get(name)
                if version is None:
                    raise KeyError(
                        f"{name!r} has only staged versions "
                        f"({sorted(versions)}); activate() one first"
                    )
            entry = versions.get(version)
            if entry is None:
                raise KeyError(
                    f"{name!r} has no version {version}; "
                    f"available: {sorted(versions)}"
                )
            return entry

    def activate(self, name: str, version: int) -> RegistryEntry:
        """Hot-swap: atomically point ``name`` at ``version``.

        The chaos hook fires *before* the pointer moves: an injected
        activation failure leaves the previous version serving — the
        degrade-don't-die contract the continuous controller relies on."""
        chaos.fire("registry.activate", name=name, version=version)
        with self._lock:
            versions = self._entries.get(name, {})
            if version not in versions:
                raise KeyError(
                    f"cannot activate {name!r} v{version}; "
                    f"available: {sorted(versions)}"
                )
            self._active[name] = version
            versions[version].ever_activated = True
            return versions[version]

    def active_version(self, name: str) -> Optional[int]:
        """Version traffic resolves to, or None while all versions are staged."""
        with self._lock:
            if name not in self._entries:
                raise KeyError(f"no servable registered under {name!r}")
            return self._active.get(name)

    def versions(self, name: str) -> Tuple[int, ...]:
        with self._lock:
            return tuple(sorted(self._entries.get(name, {})))

    def names(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._entries))

    def remove(self, name: str, version: Optional[int] = None):
        """Drop one version (or the whole name).  Removing the active
        version re-points traffic at the newest survivor that has carried
        traffic before; if only staged versions remain, the active pointer
        clears (serve nothing rather than an unvalidated staged model)."""
        with self._lock:
            versions = self._entries.get(name)
            if not versions:
                raise KeyError(f"no servable registered under {name!r}")
            if version is None:
                del self._entries[name]
                self._active.pop(name, None)
                return
            if version not in versions:
                raise KeyError(f"{name!r} has no version {version}")
            del versions[version]
            if not versions:
                del self._entries[name]
                self._active.pop(name, None)
            elif self._active.get(name) == version:
                trusted = [v for v, e in versions.items() if e.ever_activated]
                if trusted:
                    self._active[name] = max(trusted)
                else:
                    del self._active[name]
