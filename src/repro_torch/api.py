"""Estimator API of the port (counterpart of ``src/repro/api.py``).

* **Method registry**: :func:`register` adds a fit function under a name;
  :func:`resolve` maps a spec string (``"oavi"``, ``"oavi:cgavi-ihb"``,
  ``"abm"``, ``"vca"``, or a bare OAVI variant name such as ``"fast"``) to
  its :class:`MethodEntry` and variant, as the reference does.
* :func:`fit` runs the local backend on ``device`` (``None`` = the CUDA
  card; it raises without one unless the caller passes ``device="cpu"``):
  OAVI with every variant of Section 6.1 and the ``fast`` engine, and the
  paper's baselines ABM and VCA.  A list of per-class arrays fits one model
  per class (:func:`fit_classes`): with ``class_batch="auto"``, the default
  as in the reference, eligible OAVI configurations are fitted class-batched
  (:mod:`repro_torch.core.class_batch`), everything else sequentially;
  :func:`aggregate_fit_stats` rolls their counters up.
* Out-of-core OAVI: ``fit(source=...)`` (or a source as ``X``, or an array
  with ``chunk_rows``) streams through :mod:`repro_torch.streaming`;
  ``capture_state=True`` also keeps the :class:`repro_torch.online.FitState`
  that :func:`update` folds new rows into; ``fit_classes(...,
  chunk_rows=...)`` streams every class.
* :func:`save` / :func:`load` persist a model (every kind of
  :class:`VanishingIdealModel`) through :mod:`repro_torch.checkpoint.store`
  in the JAX package's format, so each package loads the other's saves
  (:func:`save_state_dict`, :func:`load_state_dict` are the shared
  protocol, also of the classifier).
* :func:`feature_transform` is the fused (FT) for OAVI models: every
  per-class term book and generator matrix concatenated into one wavefront
  evaluation plus one product (:func:`_fuse`, :func:`plan_constants`,
  :func:`eval_with_constants`).  Model sets that cannot share one plan (VCA
  models, mixed widths or dtypes, no models) go through the per-model loop
  :func:`repro_torch.core.transform.feature_transform`.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Optional,
    Protocol,
    Sequence,
    Tuple,
    runtime_checkable,
)

import numpy as np
import torch

from . import _device
from . import online as online_mod
from . import streaming as streaming_mod
from .checkpoint import store as ckpt_store
from .core import abm as abm_mod
from .core import class_batch as class_batch_mod
from .core import oavi as oavi_mod
from .core import transform as transform_mod
from .core import vca as vca_mod
from .core.oavi import OAVIModel, apply_wavefronts, wavefront_schedule
from .core.oracles import OracleConfig
from .core.vca import VCAModel
from .resilience.integrity import IntegrityError

_log = logging.getLogger("repro_torch.api")

# Canonical OAVI variant table (Section 6.1).
# name: (engine, solver, ihb, wihb)
OAVI_VARIANTS: Dict[str, Tuple[str, str, bool, bool]] = {
    "cgavi-ihb": ("oracle", "cg", True, False),
    "agdavi-ihb": ("oracle", "agd", True, False),
    "bpcgavi": ("oracle", "bpcg", False, False),
    "bpcgavi-wihb": ("oracle", "bpcg", True, True),
    "pcgavi": ("oracle", "pcg", False, False),
    "cgavi": ("oracle", "cg", False, False),
    "agdavi": ("oracle", "agd", False, False),
    "fast": ("fast", "bpcg", True, False),  # beyond-paper closed-form engine
}

_SHARDED = "backend='sharded' is not ported yet: ROADMAP.md queue 1 item 12"


# ---------------------------------------------------------------------------
# VanishingIdealModel protocol
# ---------------------------------------------------------------------------


@runtime_checkable
class VanishingIdealModel(Protocol):
    """What every fitted generator model exposes (OAVIModel, VCAModel)."""

    n: int
    psi: float
    stats: Dict

    def evaluate_G(self, Z) -> Any:
        """Evaluation matrix of all generators over Z: (q, |G|)."""
        ...

    def transform(self, Z) -> np.ndarray:
        """(FT) features for this model alone: ``|G(Z)|``."""
        ...

    def to_state_dict(self) -> Tuple[Dict[str, np.ndarray], Dict]:
        """(flat array tree, JSON-safe metadata): see :func:`save`."""
        ...

    def save(self, path: str) -> str:
        """Persist via :func:`repro_torch.api.save`."""
        ...


# ---------------------------------------------------------------------------
# Method registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MethodEntry:
    """A registered generator-construction algorithm."""

    name: str
    fit: Callable[..., VanishingIdealModel]
    variants: Tuple[str, ...] = ()
    default_variant: Optional[str] = None
    description: str = ""

    def spec(self, variant: Optional[str]) -> str:
        return f"{self.name}:{variant}" if variant else self.name


_REGISTRY: Dict[str, MethodEntry] = {}


def register(name: str, *, variants: Sequence[str] = (),
             default_variant: Optional[str] = None, description: str = ""):
    """Decorator: register ``fn(X, *, variant, psi, config, device, **kw) ->
    VanishingIdealModel`` under ``name``."""

    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"method {name!r} is already registered")
        _REGISTRY[name] = MethodEntry(name=name, fit=fn, variants=tuple(variants),
                                      default_variant=default_variant,
                                      description=description)
        return fn

    return deco


def available_methods() -> Tuple[str, ...]:
    """Every valid ``method=`` spec, e.g. ``('abm', 'oavi', 'oavi:cgavi', ...)``."""
    specs: List[str] = []
    for name in sorted(_REGISTRY):
        specs.append(name)
        specs.extend(f"{name}:{v}" for v in _REGISTRY[name].variants)
    return tuple(specs)


def resolve(spec: str) -> Tuple[MethodEntry, Optional[str]]:
    """``'oavi:cgavi-ihb'`` -> (oavi entry, ``'cgavi-ihb'``).  Also accepts
    bare method names (default variant) and bare OAVI variant names."""
    if not isinstance(spec, str):
        raise TypeError(f"method spec must be a string, got {type(spec).__name__}")
    if ":" in spec:
        name, variant = spec.split(":", 1)
        entry = _REGISTRY.get(name)
        if entry is None:
            raise ValueError(
                f"unknown method {name!r}; available: {', '.join(available_methods())}"
            )
        if variant not in entry.variants:
            raise ValueError(
                f"unknown variant {variant!r} for method {name!r}; "
                f"available: {', '.join(entry.variants) or '(none)'}"
            )
        return entry, variant
    if spec in _REGISTRY:
        entry = _REGISTRY[spec]
        return entry, entry.default_variant
    for entry in _REGISTRY.values():
        if spec in entry.variants:
            return entry, spec
    raise ValueError(
        f"unknown method {spec!r}; available: {', '.join(available_methods())}"
    )


# ---------------------------------------------------------------------------
# Registered methods
# ---------------------------------------------------------------------------


def oavi_config_for(variant: str, psi: float, **kw) -> oavi_mod.OAVIConfig:
    """Build an :class:`OAVIConfig` from a named paper variant;
    ``solver_kw`` (a dict) goes to its :class:`OracleConfig`."""
    engine, solver, ihb, wihb = OAVI_VARIANTS[variant]
    solver_cfg = OracleConfig(name=solver, **kw.pop("solver_kw", {}))
    return oavi_mod.OAVIConfig(
        psi=psi, engine=engine, solver=solver_cfg, ihb=ihb, wihb=wihb, **kw
    )


@register("oavi", variants=tuple(OAVI_VARIANTS), default_variant="fast",
          description="Oracle AVI (Algorithm 1); variants per Section 6.1")
def _fit_oavi(X, *, variant, psi, config=None, device, **kw):
    cfg = config if config is not None else oavi_config_for(variant or "fast", psi, **kw)
    return oavi_mod.fit(X, cfg, device=device)


@register("abm", description="Approximate Buchberger-Möller (Limbeck 2013)")
def _fit_abm(X, *, variant, psi, config=None, device, **kw):
    cfg = config if config is not None else abm_mod.ABMConfig(psi=psi, **kw)
    return abm_mod.fit(X, cfg, device=device)


@register("vca", description="Vanishing Component Analysis (Livni et al. 2013)")
def _fit_vca(X, *, variant, psi, config=None, device, **kw):
    cfg = config if config is not None else vca_mod.VCAConfig(psi=psi, **kw)
    return vca_mod.fit(X, cfg, device=device)


def fit(
    X,
    method: str = "oavi",
    *,
    psi: float = 0.005,
    backend: str = "auto",
    config=None,
    class_batch: str = "auto",
    source=None,
    chunk_rows: Optional[int] = None,
    capture_state: bool = False,
    device=None,
    **method_kw,
):
    """Fit a vanishing-ideal model with the selected ``method``.

    ``X`` is an (m, n) array in ``[0, 1]^n``, or a list of per-class arrays
    (one model per class, see :func:`fit_classes`; ``class_batch`` applies
    there), or a :class:`repro_torch.streaming.DataSource` (as ``source=``).
    ``method`` is a spec of :func:`available_methods`.  ``backend`` is
    ``"auto"`` or ``"local"`` (both run the local fit).  ``config`` is a
    pre-built ``OAVIConfig`` / ``ABMConfig`` / ``VCAConfig`` and overrides
    ``psi`` and ``method_kw``.  ``device=None`` means the CUDA card.
    ``**method_kw`` goes to the method's config (e.g. ``cap_terms=64``, or
    ``solver_kw={"tau": 50.0}`` for an OAVI variant's oracle).

    ``source`` fits OAVI out-of-core (:func:`repro_torch.streaming.fit`):
    the evaluation matrix is rebuilt per degree in ``chunk_rows``-row chunks
    (default :data:`repro_torch.streaming.DEFAULT_CHUNK_ROWS`) and folded
    into Gram statistics, bit for bit the in-memory fit at matched capacity.
    The source must be scaled to ``[0, 1]^n`` already.  ``chunk_rows`` with
    an array streams through the array.  ``capture_state`` (streamed fits
    only) also keeps the :class:`repro_torch.online.FitState`, as
    ``model.fit_state``, for :func:`update`.
    """
    if source is None and streaming_mod.is_source(X):
        source, X = X, None
    if source is None and chunk_rows is not None and not isinstance(X, (list, tuple)):
        source, X = streaming_mod.as_source(np.asarray(X)), None
    if source is not None:
        return _fit_streaming(source, method, psi=psi, backend=backend, config=config,
                              chunk_rows=chunk_rows, capture_state=capture_state,
                              device=device, **method_kw)
    if capture_state:
        raise ValueError(
            "capture_state=True needs the streaming fit path: pass source= "
            "(or an in-memory X together with chunk_rows=)"
        )
    if isinstance(X, (list, tuple)):
        return fit_classes(X, method, psi=psi, backend=backend, config=config,
                           class_batch=class_batch, chunk_rows=chunk_rows, device=device,
                           **method_kw)
    _check_class_batch(class_batch)
    entry, variant = resolve(method)
    _check_backend(entry, backend)
    dev = _device.resolve(device)
    model = entry.fit(np.asarray(X), variant=variant, psi=psi, config=config,
                      device=dev, **method_kw)
    model.stats["api"] = {"method": entry.spec(variant), "backend": "local",
                          "device": str(dev)}
    return model


def _check_backend(entry: MethodEntry, backend: str) -> None:
    if backend == "sharded":
        if entry.name != "oavi":
            raise ValueError(f"method {entry.name!r} does not support backend='sharded'")
        raise NotImplementedError(_SHARDED)
    if backend not in ("auto", "local"):
        raise ValueError(
            f"unknown backend {backend!r}; expected 'auto', 'local' or 'sharded'"
        )


def _fit_streaming(source, method: str, *, psi: float, backend: str, config,
                   chunk_rows: Optional[int], capture_state: bool, device, **method_kw):
    """Out-of-core dispatch: an OAVI spec to :func:`repro_torch.streaming.fit`,
    or with ``capture_state`` to :func:`repro_torch.online.fit` (the same
    fold, plus the persisted accumulators)."""
    entry, variant = resolve(method)
    if entry.name != "oavi":
        raise ValueError(f"streaming fit (source=) supports OAVI only, got method {method!r}")
    _check_backend(entry, backend)
    cfg = config if config is not None else oavi_config_for(variant or "fast", psi, **method_kw)
    dev = _device.resolve(device)
    chunk_rows = chunk_rows or streaming_mod.DEFAULT_CHUNK_ROWS
    api_stats = {"method": entry.spec(variant), "backend": "local", "device": str(dev),
                 "streaming": True}
    if capture_state:
        model, fit_state = online_mod.fit(source, cfg, chunk_rows=chunk_rows, device=dev)
        model.fit_state = fit_state
        api_stats["online"] = True
    else:
        model = streaming_mod.fit(source, cfg, chunk_rows=chunk_rows, device=dev)
    model.stats["api"] = api_stats
    return model


def update(model, state, source, **kw):
    """Refresh a :func:`fit(..., capture_state=True) <fit>` model after its
    source grew: only the new rows are folded into ``state``'s per-degree
    Gram accumulators, and the degree steps re-run; the model equals a
    refit of the grown source bit for bit at matched capacity.  Returns the
    :class:`repro_torch.online.UpdateResult`, whose ``.model`` carries the
    next ``fit_state``.  Keywords go to :func:`repro_torch.online.update`
    (``chunk_rows``, ``scaler``, ``prefetch``, ``device``, ...)."""
    result = online_mod.update(model, state, source, **kw)
    api_stats = dict(getattr(model, "stats", {}).get("api") or {})
    api_stats.update({"backend": "local", "device": str(result.model.device),
                      "streaming": True, "online": True})
    result.model.stats["api"] = api_stats
    result.model.fit_state = result.state
    return result


def _check_class_batch(class_batch: str) -> None:
    if class_batch not in ("auto", "off"):
        raise ValueError(f"unknown class_batch {class_batch!r}; expected 'auto' or 'off'")


def fit_classes(
    Xs: Sequence,
    method: str = "oavi",
    *,
    psi: float = 0.005,
    backend: str = "auto",
    config=None,
    class_batch: str = "auto",
    chunk_rows: Optional[int] = None,
    device=None,
    **method_kw,
) -> List[VanishingIdealModel]:
    """Fit one model per class (Algorithm 2's generator phase).

    With ``class_batch="auto"`` (the default, as in the reference) and an
    eligible OAVI config (:func:`repro_torch.core.oavi.class_batchable`:
    every engine with the Theorem 4.9 ``inverse``), the classes are grouped
    into shared row buckets (:func:`repro_torch.core.class_batch.
    plan_class_groups`) and each group is fitted class-batched
    (:func:`repro_torch.core.class_batch.fit_classes`): one launch of each
    kernel per degree for the group, each model bit for bit the sequential
    fit's at matched capacity.  ``class_batch="off"``, a single class, ABM,
    VCA and the Cholesky engine fit one class after another.  Each batched
    model's ``stats["class_batch_padding"]`` reports the padded rows its
    group paid.  With ``chunk_rows`` every OAVI class streams out-of-core:
    batchable configs through :func:`repro_torch.streaming.fit_classes` (one
    statistics step per degree for the group, no row padding), the others
    one streamed fit after another.  ``backend="sharded"`` is not ported
    (ROADMAP.md queue 1 item 12).  Returns the models in class order; count
    group-shared stats with :func:`aggregate_fit_stats`.
    """
    _check_class_batch(class_batch)
    entry, variant = resolve(method)
    Xs = [np.asarray(X) for X in Xs]
    dev = _device.resolve(device)
    stream = chunk_rows is not None and entry.name == "oavi"

    def seq_fit(X):
        return fit(X, method, psi=psi, backend=backend, config=config, device=dev,
                   chunk_rows=chunk_rows if stream else None, **method_kw)

    if class_batch == "off" or entry.name != "oavi" or len(Xs) < 2:
        return [seq_fit(X) for X in Xs]
    cfg = config if config is not None else oavi_config_for(variant or "fast", psi,
                                                            **dict(method_kw))
    if not oavi_mod.class_batchable(cfg):
        return [seq_fit(X) for X in Xs]  # the Cholesky engine: sequential
    _check_backend(entry, backend)
    if stream:
        fitted = streaming_mod.fit_classes(Xs, cfg, chunk_rows=chunk_rows, device=dev)
        for model in fitted:
            model.stats["api"] = {"method": entry.spec(variant), "backend": "local",
                                  "device": str(dev), "streaming": True, "class_batch": True}
        return fitted

    models: List[Optional[VanishingIdealModel]] = [None] * len(Xs)
    sizes = [X.shape[0] for X in Xs]
    for cap, idxs in class_batch_mod.plan_class_groups(sizes):
        fitted = class_batch_mod.fit_classes([Xs[i] for i in idxs], cfg, m_cap=cap,
                                             device=dev)
        mc = int(fitted[0].stats["class_batch"]["m_cap"])
        group_rows = sum(sizes[i] for i in idxs)
        group_padded = mc * len(idxs) - group_rows
        for i, model in zip(idxs, fitted):
            model.stats["api"] = {"method": entry.spec(variant), "backend": "local",
                                  "device": str(dev), "class_batch": True}
            model.stats["class_batch_padding"] = {
                "m_cap": mc,
                "rows": int(sizes[i]),
                "padded_rows": mc - int(sizes[i]),
                "group_rows": int(group_rows),
                "group_padded_rows": int(group_padded),
                # fraction of the group's rows that are padding
                "waste": group_padded / float(mc * len(idxs)),
            }
            models[i] = model
    return models


_GROUP_SHARED = ("regrowths", "solver_escalations")


def aggregate_fit_stats(models: Sequence) -> Dict:
    """Classifier-level fit counters over per-class models.

    Class-batched models of one group share one degree loop: their
    ``regrowths``, ``solver_escalations`` and ``kernel_launches`` are the
    group's, so they are counted once per group (the reference's dedup),
    and each sequentially fitted model's once.  ``solver_schedule_len`` is
    the longest schedule any group ran; ``class_batch_padding`` totals the
    groups' dispatched and padded rows.  The reference's ``recompiles`` (jit
    traces) and its metric-registry mirror have no counterpart here."""
    totals = dict.fromkeys(_GROUP_SHARED, 0)
    launches: Dict[str, int] = {}
    schedule_len: Optional[int] = None
    batched = 0
    groups = set()
    pad_groups = set()
    dispatched_rows = padded_rows = 0
    for model in models:
        stats = getattr(model, "stats", None) or {}
        sched = stats.get("solver_schedule_len")
        if sched is not None:
            schedule_len = max(int(sched), schedule_len or 0)
        padding = stats.get("class_batch_padding")
        if padding is not None:
            # group totals are replicated on every member; count each once
            pad_key = (padding["m_cap"], padding["group_rows"], padding["group_padded_rows"])
            if pad_key not in pad_groups:
                pad_groups.add(pad_key)
                dispatched_rows += int(padding["group_rows"]) + int(padding["group_padded_rows"])
                padded_rows += int(padding["group_padded_rows"])
        group = stats.get("class_batch")
        if group is not None:
            batched += 1
            if group["group"] in groups:
                continue
            groups.add(group["group"])
        for key in _GROUP_SHARED:
            totals[key] += int(stats.get(key, 0))
        for k, v in stats.get("kernel_launches", {}).items():
            launches[k] = launches.get(k, 0) + int(v)
    out: Dict = {
        **totals,
        "kernel_launches": launches,
        "class_batched": batched,
        "class_batch_groups": len(groups),
        "solver_schedule_len": schedule_len,
    }
    if dispatched_rows:
        out["class_batch_padding"] = {
            "dispatched_rows": dispatched_rows,
            "padded_rows": padded_rows,
            "waste": padded_rows / float(dispatched_rows),
        }
    return out


# ---------------------------------------------------------------------------
# Serialization: save / load through the checkpoint manifest machinery
# ---------------------------------------------------------------------------

# ABM fits are OAVIModels, saved and loaded as kind "oavi"
_MODEL_KINDS: Dict[str, type] = {"oavi": OAVIModel, "vca": VCAModel}
_FORMAT = "repro.vanishing_ideal_model.v1"


def _json_safe(obj):
    """Recursively convert numpy scalars/arrays so metadata JSON-serializes."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def _model_class(kind):
    if kind not in _MODEL_KINDS:
        raise ValueError(f"unknown model kind {kind!r}")
    return _MODEL_KINDS[kind]


def save_state_dict(path: str, arrays: Dict, meta: Dict, fmt: str, step: int = 0) -> str:
    """Write one ``(arrays, meta)`` state dict as a committed, format-tagged
    checkpoint: the save protocol shared by :func:`save` and
    ``VanishingIdealClassifier.save``.  ``step`` versions the save inside
    ``path``, so :func:`load_state_dict` has older steps to fall back to.
    Returns the committed directory."""
    metadata = {
        "format": fmt,
        "kind": meta.get("kind"),
        "meta": _json_safe(meta),
        "array_keys": sorted(arrays),
    }
    return ckpt_store.save(path, step=step, tree=dict(arrays), metadata=metadata)


def load_state_dict(path: str, fmt: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Load the newest *verifiable* committed state dict at ``path`` and
    check its format tag.  Every leaf is checksum-verified first; a corrupt
    head step falls back to the newest older step that verifies.  When every
    step is damaged the head's :class:`IntegrityError` (naming the bad file)
    propagates."""
    steps = ckpt_store.committed_steps(path)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoint under {path!r}")
    head_err: Optional[IntegrityError] = None
    for step in reversed(steps):
        try:
            metadata, _ = ckpt_store.read_metadata(path, step)
            if metadata.get("format") != fmt:
                raise ValueError(
                    f"{path!r} is not a {fmt} checkpoint "
                    f"(format={metadata.get('format')!r})"
                )
            like = {k: np.zeros(()) for k in metadata["array_keys"]}
            arrays, metadata = ckpt_store.restore(path, step, like)
        except (IntegrityError, json.JSONDecodeError) as e:
            _log.warning("checkpoint step %d at %r failed verification: %s", step, path, e)
            if head_err is None:
                head_err = e if isinstance(e, IntegrityError) else IntegrityError(str(e))
            continue
        if step != steps[-1]:
            _log.warning("loaded step %d from %r (newest committed step %d is corrupt)",
                         step, path, steps[-1])
        return arrays, metadata
    raise head_err


def save(model, path: str) -> str:
    """Persist a fitted model to ``path`` (a directory) atomically."""
    arrays, meta = model.to_state_dict()
    _model_class(meta.get("kind"))
    return save_state_dict(path, arrays, meta, _FORMAT)


def load(path: str, *, device=None):
    """Load a model written by :func:`save` (by either package) onto
    ``device`` (``None`` = the CUDA card); the port's own round trip is
    bit-identical."""
    arrays, metadata = load_state_dict(path, _FORMAT)
    cls = _model_class(metadata["kind"])
    return cls.from_state_dict(arrays, metadata["meta"], device=device)


# ---------------------------------------------------------------------------
# Fused batched transform
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _FusedPlan:
    """All per-class term books and generator matrices concatenated into one
    global book (constant term shared at index 0) so the whole (FT) is one
    wavefront evaluation plus one product."""

    parents: np.ndarray  # (L,) global term book parent chain
    vars: np.ndarray  # (L,) variable indices in ORIGINAL Z coords
    C: np.ndarray  # (L, Ktot) block-diagonal generator coefficients
    gp: np.ndarray  # (Ktot,) leading-term parent (global index)
    gv: np.ndarray  # (Ktot,) leading-term variable (original coords)
    dtype: np.dtype
    num_features: int
    n: int  # input dimension (original Z coordinates)


def _fuse(models: Sequence) -> Optional[_FusedPlan]:
    """Build the fused plan, or None when the models cannot share one (mixed
    input widths or dtypes)."""
    models = list(models)
    if not models or not all(isinstance(m, OAVIModel) for m in models):
        return None
    n = models[0].n
    if any(m.n != n for m in models):
        return None
    dtype = np.dtype(models[0].dtype)
    if any(np.dtype(m.dtype) != dtype for m in models):
        return None
    g_parents: List[np.ndarray] = [np.zeros((1,), np.int64)]
    g_vars: List[np.ndarray] = [np.zeros((1,), np.int64)]
    c_blocks: List[Tuple[int, np.ndarray]] = []  # (row offset, (ell_b, k_b))
    gp_all: List[np.ndarray] = []
    gv_all: List[np.ndarray] = []
    offset = 1  # global slot of each model's first non-constant term
    for m in models:
        if m.num_G == 0:
            continue  # contributes no feature columns; skip its book entirely
        perm = (
            np.asarray(m.feature_perm, np.int64)
            if m.feature_perm is not None
            else np.arange(n, dtype=np.int64)
        )
        pb, vb = m.term_arrays()
        ell = pb.shape[0]
        C, gp, gv = m.generator_arrays()
        c_blocks.append((offset, C.astype(dtype, copy=False)))
        gp_all.append(np.where(gp == 0, 0, offset + gp - 1).astype(np.int64))
        gv_all.append(perm[gv])
        if ell > 1:
            g_parents.append(np.where(pb[1:] == 0, 0, offset + pb[1:] - 1).astype(np.int64))
            g_vars.append(perm[vb[1:]])
        offset += ell - 1
    L = offset
    num_features = sum(b.shape[1] for _, b in c_blocks)
    C = np.zeros((L, num_features), dtype)
    col = 0
    for row_off, Cb in c_blocks:
        k = Cb.shape[1]
        C[0, col : col + k] = Cb[0]  # constant-term coefficients
        C[row_off : row_off + Cb.shape[0] - 1, col : col + k] = Cb[1:]
        col += k
    return _FusedPlan(
        parents=np.concatenate(g_parents),
        vars=np.concatenate(g_vars),
        C=C,
        gp=np.concatenate(gp_all) if gp_all else np.zeros((0,), np.int64),
        gv=np.concatenate(gv_all) if gv_all else np.zeros((0,), np.int64),
        dtype=dtype,
        num_features=num_features,
        n=n,
    )


@dataclasses.dataclass(frozen=True)
class PlanConstants:
    """The fused (FT) evaluation's constants, on the device.

    They depend only on the fitted models, never on the query batch.  The
    fused column order is not degree-grouped, so the wavefront permutation is
    folded into the constants: the generator rows are pre-gathered into
    wavefront order, and the leading-term parent index points at the
    wavefront column.  (The JAX package keeps one-hot selectors for the TPU's
    matrix unit; on the GPU they are index gathers.)
    """

    waves: Tuple  # wavefront schedule over the fused book (device index tensors)
    C_w: torch.Tensor  # (L, k) generator coefficients, wavefront row order
    gp_w: torch.Tensor  # (k,) leading-term parent column, wavefront order
    gv: torch.Tensor  # (k,) leading-term variable
    num_features: int
    n: int


def plan_constants(plan: _FusedPlan, device) -> PlanConstants:
    """Move every constant of the fused evaluation to ``device`` once."""
    waves, perm = wavefront_schedule(plan.parents, plan.vars)
    if perm is not None:
        # cols_original = cols_wave[:, perm]  =>  cols_original @ C ==
        # cols_wave @ C[order] with order = argsort(perm)
        C_w = np.ascontiguousarray(plan.C[np.argsort(perm)])
        gp_w = perm[plan.gp]
    else:
        C_w, gp_w = plan.C, plan.gp
    dev = torch.device(device)
    return PlanConstants(
        waves=tuple(
            (torch.as_tensor(p, device=dev), torch.as_tensor(v, device=dev))
            for p, v in waves
        ),
        C_w=torch.as_tensor(C_w, device=dev),
        gp_w=torch.as_tensor(gp_w, device=dev),
        gv=torch.as_tensor(plan.gv, device=dev),
        num_features=plan.num_features,
        n=plan.n,
    )


def _row_stable_product(cols: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """``cols @ C`` with each output summed over its own row in one fixed
    order, whatever the number of rows.

    cuBLAS chooses its kernel, and with it the summation order, by the number
    of rows (on an H100, one-row chunks, even padded to two rows, gave other
    last bits than one 300-row call), so on the card the product is summed
    term by term, one multiply-add pass over the (q, k) output per row of
    ``C``.  The CPU keeps the BLAS product, whose rows are independent there
    (the CPU tests hold direct, chunked and single-row transforms equal).
    """
    if cols.device.type != "cuda":
        return cols @ C
    acc = cols[:, :1] * C[0]
    for j in range(1, C.shape[0]):
        acc = torch.addcmul(acc, cols[:, j : j + 1], C[j])
    return acc


def eval_with_constants(consts: PlanConstants, Z: torch.Tensor) -> torch.Tensor:
    """Fused (FT) body: a degree-wavefront term sweep plus one product, row
    for row the same bits whatever the batch (:func:`_row_stable_product`)."""
    cols = apply_wavefronts(Z, consts.waves)  # (q, L) in wavefront order
    lead = cols[:, consts.gp_w] * Z[:, consts.gv]
    return torch.abs(_row_stable_product(cols, consts.C_w) + lead)


def feature_transform(
    models: Sequence,
    Z,
    *,
    batch_size: Optional[int] = None,
    dtype: Optional[str] = None,
    device=None,
) -> np.ndarray:
    """(FT) over all per-class models as ONE fused evaluation, or through
    the per-model loop where the models cannot share one plan.

    ``device=None`` evaluates the fused plan where the first model lives.
    ``batch_size`` streams ``Z`` through the device in row chunks.  Returns
    host numpy.
    """
    if batch_size is not None and batch_size < 1:
        raise ValueError(f"batch_size must be a positive integer, got {batch_size}")
    models = list(models)
    plan = _fuse(models)
    if plan is None:
        # VCA models, mixed widths or dtypes, or no models: each model on its
        # own device in its own dtype, as the reference falls back
        return transform_mod.feature_transform(models, Z, dtype=dtype)
    Z = np.asarray(Z)
    out_dtype = np.dtype(dtype) if dtype is not None else plan.dtype
    q = Z.shape[0]
    if plan.num_features == 0:
        return np.zeros((q, 0), out_dtype)
    dev = models[0].device if device is None else _device.resolve(device)
    consts = plan_constants(plan, dev)
    tdtype = getattr(torch, plan.dtype.name)
    step = q if batch_size is None else batch_size
    out = np.empty((q, plan.num_features), out_dtype)
    for start in range(0, q, step):
        res = eval_with_constants(consts, _device.tensor(Z[start : start + step], tdtype, dev))
        out[start : start + step] = res.cpu().numpy().astype(out_dtype, copy=False)
    return out


__all__ = [
    "MethodEntry",
    "OAVI_VARIANTS",
    "PlanConstants",
    "aggregate_fit_stats",
    "available_methods",
    "eval_with_constants",
    "feature_transform",
    "fit",
    "fit_classes",
    "load",
    "load_state_dict",
    "oavi_config_for",
    "plan_constants",
    "register",
    "resolve",
    "save",
    "save_state_dict",
    "update",
    "VanishingIdealModel",
]
