"""The device rule of the port's entry points."""

from __future__ import annotations

import numpy as np
import torch


def resolve(device=None) -> torch.device:
    """``None`` means the CUDA card; without one, raise rather than fall back.

    The CPU runs only when the caller asks for it (``device="cpu"``).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}: expected 'cpu' or 'cuda'")
    return dev


def tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``x`` (an array or a tensor) as a ``dtype`` tensor on ``device``."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)
