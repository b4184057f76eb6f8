"""Architecture registry of the port: the dense and MoE families.

Counterpart of ``src/repro/configs/__init__.py``.  ``get_config(arch_id)`` /
``get_reduced(arch_id)`` resolve ``--arch`` flags; the four dense and two
MoE config modules are copies of the JAX package's.  The other architectures
of the JAX registry raise ``NotImplementedError`` naming the ROADMAP item
that ports their blocks.
"""

from __future__ import annotations

from typing import Dict

from ..models.model import ModelConfig
from . import (deepseek_v2_lite_16b, kimi_k2_1t_a32b, phi4_mini_3_8b, qwen1_5_4b, qwen2_1_5b,
               qwen3_8b, shapes)
from .shapes import SHAPES, Shape, cell_supported

_MODULES = [
    qwen3_8b,
    qwen1_5_4b,
    qwen2_1_5b,
    phi4_mini_3_8b,
    kimi_k2_1t_a32b,
    deepseek_v2_lite_16b,
]

ARCHS: Dict[str, object] = {m.ARCH_ID: m for m in _MODULES}

# architectures of the JAX registry that need blocks this slice lacks
UNPORTED: Dict[str, str] = {
    "xlstm-1.3b": "14d (SSM)",
    "jamba-1.5-large-398b": "14d (SSM)",
    "hubert-xlarge": "14e (frames frontend)",
    "qwen2-vl-2b": "14f (M-RoPE)",
}


def _module(arch_id: str):
    if arch_id in UNPORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is ROADMAP queue 1 item {UNPORTED[arch_id]}")
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
