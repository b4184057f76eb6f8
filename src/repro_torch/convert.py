"""Carry fitted parameters from the JAX package into the port.

The JAX package's models serialize to a flat dict of numpy arrays plus JSON
metadata (``OAVIModel.to_state_dict`` -- also ABM's models --,
``VCAModel.to_state_dict`` and ``VanishingIdealClassifier.to_state_dict`` in
``repro``), and its LM keeps
its parameters, and its optimizer its moments, in pytrees of arrays.  The
functions here build the port's
objects from that output, so both packages compute the same thing from the
same parameters.  They read plain numpy and dicts only.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .core.oavi import OAVIModel
from .core.pipeline import VanishingIdealClassifier
from .core.vca import VCAModel


def oavi_model_from_reference(arrays: Dict[str, np.ndarray], meta: Dict,
                              device=None) -> OAVIModel:
    """Port :class:`OAVIModel` from ``repro``'s ``OAVIModel.to_state_dict()``
    (an OAVI or an ABM fit)."""
    if meta.get("kind") != "oavi":
        raise ValueError(f"expected an OAVI model, got kind {meta.get('kind')!r}")
    return OAVIModel.from_state_dict(arrays, meta, device=device)


def vca_model_from_reference(arrays: Dict[str, np.ndarray], meta: Dict,
                             device=None) -> VCAModel:
    """Port :class:`VCAModel` from ``repro``'s ``VCAModel.to_state_dict()``."""
    if meta.get("kind") != "vca":
        raise ValueError(f"expected a VCA model, got kind {meta.get('kind')!r}")
    return VCAModel.from_state_dict(arrays, meta, device=device)


def classifier_from_reference(arrays: Dict[str, np.ndarray], meta: Dict,
                              device=None) -> VanishingIdealClassifier:
    """Port :class:`VanishingIdealClassifier` from ``repro``'s
    ``VanishingIdealClassifier.to_state_dict()``: the scaler, the per-class
    models (OAVI, ABM or VCA) and the SVM head."""
    return VanishingIdealClassifier.from_state_dict(arrays, meta, device=device)


def lm_params_from_reference(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """The port's LM state dict (CPU tensors, keys of
    :class:`repro_torch.models.model.Transformer`) from the JAX package's
    ``init_params`` pytree, its leaves as numpy arrays.

    The JAX package stacks each period position over a leading
    ``(n_periods, ...)`` axis (``params["blocks"]["00_attn"]["wq"][i]``); the
    port holds one module per sub-block, sub-block ``i * len(period) + j``
    being period ``i``'s position ``j``.
    """
    return {k: _tensor(v) for k, v in _unstack(params, cfg).items()}


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bf16: carry the bits
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _unstack(tree: Dict[str, Any], cfg) -> Dict[str, np.ndarray]:
    """The port's parameter names -> arrays of a pytree shaped like the JAX
    package's params (period axis unstacked).  A ``frames`` config carries
    ``embed_proj`` where a token config carries ``embed``."""
    embed = "embed" if cfg.frontend == "tokens" else "embed_proj"
    out = {embed: np.asarray(tree[embed]), "final_norm": np.asarray(tree["final_norm"])}
    if not cfg.tie_embeddings:
        out["head"] = np.asarray(tree["head"])
    n_pos = len(cfg.period)
    for j, btype in enumerate(cfg.period):
        for leaf, stacked in tree["blocks"][f"{j:02d}_{btype}"].items():
            stacked = np.asarray(stacked)
            if stacked.shape[0] != cfg.n_periods:
                raise ValueError(f"{btype}.{leaf}: leading axis {stacked.shape[0]}, "
                                 f"expected n_periods={cfg.n_periods}")
            for i in range(cfg.n_periods):
                out[f"blocks.{i * n_pos + j}.{leaf}"] = stacked[i]
    return out


def adamw_state_from_reference(state, cfg):
    """The port's :class:`~repro_torch.optim.AdamWState` (CPU tensors, keyed
    by the port's parameter names) from the JAX package's ``AdamWState``
    for the model of ``cfg``, its leaves as numpy arrays.

    fp32 moments are unstacked as :func:`lm_params_from_reference` unstacks
    the weights.  Quantized moments, ``(int8 blocks, scale)`` over a whole
    stacked leaf, are dequantized, unstacked and quantized again per
    parameter: the codes and scales are the reference's wherever a period's
    share of a leaf is a whole number of 256-value blocks, and within one
    quantization step elsewhere.
    """
    from .models.model import Transformer
    from .optim.adamw import AdamWState, _dequantize, _quantize

    shapes = {k: tuple(v.shape) for k, v in
              Transformer(cfg, device="meta", seed=None).state_dict().items()}

    def dequantized(pair, shape):
        q, scale = (torch.from_numpy(np.array(a)) for a in pair)
        return _dequantize(q, scale, shape).numpy()

    def moments(tree):
        if not isinstance(tree["final_norm"], (tuple, list)):  # fp32 leaves
            return {k: _tensor(v) for k, v in _unstack(tree, cfg).items()}
        full = {k: dequantized(v, shapes[k]) for k, v in tree.items() if k != "blocks"}
        full["blocks"] = {
            key: {leaf: dequantized(pair, (cfg.n_periods,)
                                    + shapes[f"blocks.{int(key[:2])}.{leaf}"])
                  for leaf, pair in block.items()}
            for key, block in tree["blocks"].items()}
        return {k: _quantize(torch.from_numpy(v)) for k, v in _unstack(full, cfg).items()}

    return AdamWState(step=int(np.asarray(state.step)), mu=moments(state.mu),
                      nu=moments(state.nu))
