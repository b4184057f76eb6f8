"""Optimizer substrate: AdamW (fp32 / 8-bit states), schedules, compression.

Counterpart of ``src/repro/optim``, in tensor ops.
"""

from .adamw import (AdamW, AdamWState, compress_grads, decompress_grads, init_residuals,
                    warmup_cosine)

__all__ = ["AdamW", "AdamWState", "warmup_cosine", "compress_grads", "decompress_grads",
           "init_residuals"]
