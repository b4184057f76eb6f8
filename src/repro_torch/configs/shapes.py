"""The assigned input-shape grid and each cell's inputs (from
``src/repro/configs/shapes.py``).

Four shapes per architecture (40 cells):

    train_4k     seq=4096    global_batch=256   -> train step
    prefill_32k  seq=32768   global_batch=32    -> prefill
    decode_32k   seq=32768   global_batch=128   -> decode step (1 new token)
    long_500k    seq=524288  global_batch=1     -> decode step (sub-quadratic only)

``input_specs`` gives a cell's step inputs as ``meta`` tensors (shape and
type, no storage), the reference's ``ShapeDtypeStruct`` stand-ins;
``cell_supported`` encodes the documented skips.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

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


def input_specs(cfg: ModelConfig, shape: Shape) -> Dict[str, torch.Tensor]:
    """The step's inputs on ``meta``, with the reference's shapes and types
    (token ids int32; frames in the model's type)."""
    B, S = shape.global_batch, shape.seq_len

    def spec(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "train":
        if cfg.frontend == "tokens":
            # +1 position: loss_fn shifts inputs and labels
            return {"tokens": spec(B, S + 1)}
        return {"frames": spec(B, S, cfg.d_model, dtype=cfg.torch_dtype()),
                "labels": spec(B, S)}
    if shape.kind == "prefill":
        if cfg.frontend == "tokens":
            return {"tokens": spec(B, S)}
        return {"frames": spec(B, S, cfg.d_model, dtype=cfg.torch_dtype())}
    # decode: one token against a seq_len-deep cache
    return {"token": spec(B), "pos": spec(B)}
