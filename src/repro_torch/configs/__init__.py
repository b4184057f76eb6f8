"""Architecture registry of the port: every architecture of the JAX
registry (dense, MoE, SSM, hybrid, audio and VLM families).

Counterpart of ``src/repro/configs/__init__.py``.  ``get_config(arch_id)`` /
``get_reduced(arch_id)`` resolve ``--arch`` flags; the ten config modules are
copies of the JAX package's.  ``get_optimized`` is the reference's tuned
profile (chunked attention, rowwise MoE dispatch) and ``all_cells`` the dry
run's grid of (architecture, shape) cells.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from ..models.model import ModelConfig
from . import (deepseek_v2_lite_16b, hubert_xlarge, jamba_1_5_large_398b, kimi_k2_1t_a32b,
               phi4_mini_3_8b, qwen1_5_4b, qwen2_1_5b, qwen2_vl_2b, qwen3_8b, shapes,
               xlstm_1_3b)
from .shapes import SHAPES, Shape, cell_supported, input_specs

_MODULES = [
    qwen3_8b,
    qwen1_5_4b,
    qwen2_1_5b,
    phi4_mini_3_8b,
    kimi_k2_1t_a32b,
    deepseek_v2_lite_16b,
    xlstm_1_3b,
    hubert_xlarge,
    qwen2_vl_2b,
    jamba_1_5_large_398b,
]

ARCHS: Dict[str, object] = {m.ARCH_ID: m for m in _MODULES}

# architectures of the JAX registry that the port lacks, and the ROADMAP
# item that ports each (none left)
UNPORTED: Dict[str, str] = {}


def _module(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; options: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).config()


def get_reduced(arch_id: str) -> ModelConfig:
    return _module(arch_id).reduced()


def get_optimized(arch_id: str) -> ModelConfig:
    """The reference's beyond-paper tuned profile: chunked attention
    everywhere (``attn_chunk`` 1024) and, for a MoE, the row-local dispatch.
    ``get_config`` stays the paper-faithful baseline."""
    cfg = get_config(arch_id)
    cfg = dataclasses.replace(cfg, attn_impl="chunked", attn_chunk=1024)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=cfg.moe._replace(dispatch="rowwise"))
    return cfg


def all_cells() -> List[Tuple[str, str, bool, str]]:
    """Every (arch_id, shape name, supported, why not) of the dry run's grid:
    40 cells, 31 of them supported."""
    out = []
    for arch_id in ARCHS:
        cfg = get_config(arch_id)
        for shape in SHAPES.values():
            ok, why = cell_supported(cfg, shape)
            out.append((arch_id, shape.name, ok, why))
    return out


__all__ = [
    "ARCHS",
    "UNPORTED",
    "get_config",
    "get_reduced",
    "get_optimized",
    "all_cells",
    "SHAPES",
    "Shape",
    "cell_supported",
    "input_specs",
    "shapes",
]
