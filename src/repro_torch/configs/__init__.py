"""Architecture registry of the port: every architecture of the JAX
registry (dense, MoE, SSM, hybrid, audio and VLM families).

Counterpart of ``src/repro/configs/__init__.py``.  ``get_config(arch_id)`` /
``get_reduced(arch_id)`` resolve ``--arch`` flags; the ten config modules are
copies of the JAX package's.  ``get_optimized`` and ``all_cells`` (the dry
run's) are ROADMAP queue 1 item 14h.
"""

from __future__ import annotations

from typing import Dict

from ..models.model import ModelConfig
from . import (deepseek_v2_lite_16b, hubert_xlarge, jamba_1_5_large_398b, kimi_k2_1t_a32b,
               phi4_mini_3_8b, qwen1_5_4b, qwen2_1_5b, qwen2_vl_2b, qwen3_8b, shapes,
               xlstm_1_3b)
from .shapes import SHAPES, Shape, cell_supported

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


__all__ = [
    "ARCHS",
    "UNPORTED",
    "get_config",
    "get_reduced",
    "SHAPES",
    "Shape",
    "cell_supported",
    "shapes",
]
