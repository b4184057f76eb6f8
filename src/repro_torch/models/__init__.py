"""The LM substrate: config-driven architectures, dense, MoE, MLA, SSM and
hybrid (counterpart of ``src/repro/models/``)."""

from . import attention, hints, layers, mla, model, moe, ssm
from .model import ModelConfig, Transformer, abstract_params, loss_fn

__all__ = [
    "attention", "hints", "layers", "mla", "model", "moe", "ssm",
    "ModelConfig", "Transformer", "abstract_params", "loss_fn",
]
