"""Launcher of the hand-written CUDA IHB update (``csrc/ihb_update.cu``).

The CUDA counterpart of the Pallas kernel ``ihb_update``
(``src/repro/kernels/ihb_update.py``): the Theorem 4.9 block-inverse update
of the padded inverse ``N`` after appending a column at slot ``ell``.  It
writes out of place.  ``btb``, ``ell`` and the optional ``active`` flag stay
on the device, so a caller's candidate loop needs no host sync.  The plain
PyTorch version is :func:`repro_torch.kernels.ref.ihb_update_ref`.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

# kernel launches made through this wrapper
launches = {"ihb_update": 0}


def _device_scalar(v, dtype, device, name: str) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        if v.numel() != 1 or v.device != device:
            raise ValueError(
                f"{name} must be one value on {device}, got "
                f"{tuple(v.shape)} on {v.device}"
            )
        return v.reshape(1).to(dtype)
    return torch.tensor([v], dtype=dtype, device=device)


def ihb_update(N, q, btb, ell, active: Optional[torch.Tensor] = None):
    """Updated padded inverse, a new ``(L, L)`` tensor; ``N`` is unchanged.

    ``active`` (a one-element bool tensor on the card) skips the update when
    false: the result is then a copy of ``N``.
    """
    device = N.device
    if device.type != "cuda":
        raise ValueError(f"ihb_update kernel needs CUDA tensors, got {device}")
    if N.dim() != 2 or N.shape[0] != N.shape[1]:
        raise ValueError(f"N must be square, got {tuple(N.shape)}")
    L = N.shape[0]
    for name, t, shape in (("N", N, (L, L)), ("q", q, (L,))):
        if t.device != device or t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous of shape {shape}")
    btb_t = _device_scalar(btb, torch.float32, device, "btb")
    ell_t = _device_scalar(ell, torch.int32, device, "ell")
    act = None
    if active is not None:
        act = _device_scalar(active, torch.bool, device, "active")
    out = torch.empty_like(N)
    u = torch.empty(L + 1, dtype=torch.float32, device=device)
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.repro_ihb_update(
            N.data_ptr(), q.data_ptr(), btb_t.data_ptr(), ell_t.data_ptr(),
            act.data_ptr() if act is not None else None,
            out.data_ptr(), u.data_ptr(), L, stream,
        )
    _build.check(err, "ihb_update")
    launches["ihb_update"] += 1
    return out
