"""The assigned input-shape grid (from ``src/repro/configs/shapes.py``).

``input_specs`` is not ported: it builds JAX shape stand-ins for the dry run
(ROADMAP queue 1 item 14h).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from ..models.model import ModelConfig


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}


def cell_supported(cfg: ModelConfig, shape: Shape) -> Tuple[bool, str]:
    if shape.kind == "decode":
        if not cfg.supports_decode:
            return False, "encoder-only: no autoregressive decode"
        if shape.name == "long_500k" and not cfg.sub_quadratic:
            return False, "full quadratic attention: 500k decode excluded (DESIGN.md)"
    return True, ""
