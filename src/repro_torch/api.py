"""Estimator API of the port, OAVI only (counterpart of ``src/repro/api.py``).

* :func:`resolve` maps a spec string (``"oavi"``, ``"oavi:cgavi-ihb"``, or a
  bare variant name such as ``"fast"``) to a method and variant, as the
  reference does; methods that are not ported yet (``abm``, ``vca``) raise
  :class:`NotImplementedError` naming the ROADMAP item that ports them.
* :func:`fit` runs the local backend on ``device`` (``None`` = the CUDA
  card; it raises without one unless the caller passes ``device="cpu"``),
  for every OAVI variant of Section 6.1 and the ``fast`` engine.  A list of
  per-class arrays fits one model per class, sequentially.
* :func:`save` / :func:`load` persist a model through
  :mod:`repro_torch.checkpoint.store` in the JAX package's format, so each
  package loads the other's saves (:func:`save_state_dict`,
  :func:`load_state_dict` are the shared protocol, also of the classifier).
* :func:`feature_transform` is the fused (FT): every per-class term book and
  generator matrix concatenated into one wavefront evaluation plus one
  product (:func:`_fuse`, :func:`plan_constants`, :func:`eval_with_constants`).
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _device
from .checkpoint import store as ckpt_store
from .core import oavi as oavi_mod
from .core.oavi import OAVIModel, apply_wavefronts, wavefront_schedule
from .core.oracles import OracleConfig
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

# method name -> (variants, default variant); only OAVI runs
METHODS: Dict[str, Tuple[Tuple[str, ...], Optional[str]]] = {
    "oavi": (tuple(OAVI_VARIANTS), "fast"),
    "abm": ((), None),
    "vca": ((), None),
}

_TODO = {
    "abm": "method 'abm' is not ported yet: ROADMAP.md queue 1 item 9",
    "vca": "method 'vca' is not ported yet: ROADMAP.md queue 1 item 9",
    "sharded": "backend='sharded' is not ported yet: ROADMAP.md queue 1 item 12",
    "chunk_rows": "chunk_rows (out-of-core fits) is not ported yet: "
                  "ROADMAP.md queue 1 item 11",
    "class_batch": "class_batch='auto' (class-batched fits) is not ported yet: "
                   "ROADMAP.md queue 1 item 10; use class_batch='off'",
}


def available_methods() -> Tuple[str, ...]:
    """Every valid ``method=`` spec, e.g. ``('abm', 'oavi', 'oavi:cgavi', ...)``."""
    specs: List[str] = []
    for name in sorted(METHODS):
        specs.append(name)
        specs.extend(f"{name}:{v}" for v in METHODS[name][0])
    return tuple(specs)


def resolve(spec: str) -> Tuple[str, Optional[str]]:
    """``'oavi:cgavi-ihb'`` -> ``('oavi', 'cgavi-ihb')``.  Also accepts bare
    method names (default variant) and bare OAVI variant names."""
    if not isinstance(spec, str):
        raise TypeError(f"method spec must be a string, got {type(spec).__name__}")
    if ":" in spec:
        name, variant = spec.split(":", 1)
        if name not in METHODS:
            raise ValueError(
                f"unknown method {name!r}; available: {', '.join(available_methods())}"
            )
        if variant not in METHODS[name][0]:
            raise ValueError(
                f"unknown variant {variant!r} for method {name!r}; "
                f"available: {', '.join(METHODS[name][0]) or '(none)'}"
            )
        return name, variant
    if spec in METHODS:
        return spec, METHODS[spec][1]
    for name, (variants, _) in METHODS.items():
        if spec in variants:
            return name, spec
    raise ValueError(
        f"unknown method {spec!r}; available: {', '.join(available_methods())}"
    )


def oavi_config_for(variant: str, psi: float, **kw) -> oavi_mod.OAVIConfig:
    """Build an :class:`OAVIConfig` from a named paper variant;
    ``solver_kw`` (a dict) goes to its :class:`OracleConfig`."""
    engine, solver, ihb, wihb = OAVI_VARIANTS[variant]
    solver_cfg = OracleConfig(name=solver, **kw.pop("solver_kw", {}))
    return oavi_mod.OAVIConfig(
        psi=psi, engine=engine, solver=solver_cfg, ihb=ihb, wihb=wihb, **kw
    )


def fit(
    X,
    method: str = "oavi",
    *,
    psi: float = 0.005,
    backend: str = "auto",
    config: Optional[oavi_mod.OAVIConfig] = None,
    class_batch: str = "off",
    chunk_rows: Optional[int] = None,
    device=None,
    **method_kw,
):
    """Fit a vanishing-ideal model with the selected ``method``.

    ``X`` is an (m, n) array in ``[0, 1]^n``, or a list of per-class arrays
    (one model per class, see :func:`fit_classes`).  ``backend`` is ``"auto"``
    or ``"local"`` (both run the local fit).  ``device=None`` means the CUDA
    card.  ``**method_kw`` goes to :class:`OAVIConfig` (e.g. ``cap_terms=64``,
    or ``solver_kw={"tau": 50.0}`` for the variant's oracle).
    """
    if chunk_rows is not None:
        raise NotImplementedError(_TODO["chunk_rows"])
    if isinstance(X, (list, tuple)):
        return fit_classes(X, method, psi=psi, backend=backend, config=config,
                           class_batch=class_batch, device=device, **method_kw)
    name, variant = resolve(method)
    if name != "oavi":
        raise NotImplementedError(_TODO[name])
    if backend == "sharded":
        raise NotImplementedError(_TODO["sharded"])
    if backend not in ("auto", "local"):
        raise ValueError(
            f"unknown backend {backend!r}; expected 'auto', 'local' or 'sharded'"
        )
    dev = _device.resolve(device)
    cfg = config if config is not None else oavi_config_for(
        variant or "fast", psi, **method_kw
    )
    model = oavi_mod.fit(np.asarray(X), cfg, device=dev)
    model.stats["api"] = {"method": f"oavi:{variant}", "backend": "local",
                          "device": str(dev)}
    return model


def fit_classes(
    Xs: Sequence,
    method: str = "oavi",
    *,
    psi: float = 0.005,
    backend: str = "auto",
    config: Optional[oavi_mod.OAVIConfig] = None,
    class_batch: str = "off",
    device=None,
    **method_kw,
) -> List[OAVIModel]:
    """Fit one model per class, sequentially (Algorithm 2's generator phase)."""
    if class_batch == "auto":
        raise NotImplementedError(_TODO["class_batch"])
    if class_batch != "off":
        raise ValueError(f"unknown class_batch {class_batch!r}; expected 'auto' or 'off'")
    dev = _device.resolve(device)
    return [
        fit(X, method, psi=psi, backend=backend, config=config, device=dev,
            **method_kw)
        for X in Xs
    ]


def aggregate_fit_stats(models: Sequence) -> Dict:
    """Classifier-level fit counters over sequentially fitted per-class
    models: regrowths and kernel launches summed over the classes."""
    regrowths = 0
    launches: Dict[str, int] = {}
    for model in models:
        stats = getattr(model, "stats", None) or {}
        regrowths += int(stats.get("regrowths", 0))
        for k, v in stats.get("kernel_launches", {}).items():
            launches[k] = launches.get(k, 0) + int(v)
    return {"regrowths": regrowths, "kernel_launches": launches}


# ---------------------------------------------------------------------------
# Serialization: save / load through the checkpoint manifest machinery
# ---------------------------------------------------------------------------

_MODEL_KINDS: Dict[str, type] = {"oavi": OAVIModel}
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
    if kind in ("vca", "abm"):
        raise NotImplementedError(f"{kind!r} models are not ported yet: "
                                  "ROADMAP.md queue 1 item 9")
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


def eval_with_constants(consts: PlanConstants, Z: torch.Tensor) -> torch.Tensor:
    """Fused (FT) body: a degree-wavefront term sweep plus one product."""
    cols = apply_wavefronts(Z, consts.waves)  # (q, L) in wavefront order
    lead = cols[:, consts.gp_w] * Z[:, consts.gv]
    return torch.abs(cols @ consts.C_w + lead)


def feature_transform(
    models: Sequence,
    Z,
    *,
    batch_size: Optional[int] = None,
    dtype: Optional[str] = None,
    device=None,
) -> np.ndarray:
    """(FT) over all per-class models as ONE fused evaluation.

    ``device=None`` evaluates where the first model lives.  ``batch_size``
    streams ``Z`` through the device in row chunks.  Returns host numpy.
    """
    if batch_size is not None and batch_size < 1:
        raise ValueError(f"batch_size must be a positive integer, got {batch_size}")
    models = list(models)
    Z = np.asarray(Z)
    plan = _fuse(models)
    if plan is None:
        raise ValueError("feature_transform needs OAVI models of one width and dtype")
    out_dtype = np.dtype(dtype) if dtype is not None else plan.dtype
    q = Z.shape[0]
    if plan.num_features == 0:
        return np.zeros((q, 0), out_dtype)
    dev = models[0].device if device is None else _device.resolve(device)
    consts = plan_constants(plan, dev)
    tdtype = getattr(torch, plan.dtype.name)
    step = q if batch_size is None else batch_size
    out = np.empty((q, plan.num_features), out_dtype)
    for start in range(0, q, max(step, 1)):
        res = eval_with_constants(consts, _device.tensor(Z[start : start + step], tdtype, dev))
        out[start : start + step] = res.cpu().numpy().astype(out_dtype, copy=False)
    return out


__all__ = [
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
    "resolve",
    "save",
    "save_state_dict",
]
