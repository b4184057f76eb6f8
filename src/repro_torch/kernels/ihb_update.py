"""Launchers of the hand-written CUDA IHB kernels (``csrc/ihb_update.cu``).

The CUDA counterpart of the Pallas kernel ``ihb_update``
(``src/repro/kernels/ihb_update.py``): the Theorem 4.9 block-inverse update
of the padded inverse ``N`` after appending a column at slot ``ell``, and the
fast engine's whole candidate loop of one degree built on it.  Both are one
cooperative launch and update ``N`` in place, touching only its leading
active block.  Scalars that the device decides (``btb``, ``ell``,
``active``) stay on the device, so nothing here syncs with the host.  The
plain PyTorch versions are :func:`repro_torch.kernels.ref.ihb_update_ref`
and :func:`repro_torch.kernels.ref.ihb_degree_ref`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

# kernel launches made through these wrappers
launches = {"ihb_update": 0, "ihb_degree": 0}


def _check(name: str, t: torch.Tensor, dtype, device, shape=None) -> None:
    if t.device != device or t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} on {device}, got {t.dtype} on {t.device}")
    if shape is None:
        if t.numel() != 1:
            raise ValueError(f"{name} must hold one value, got shape {tuple(t.shape)}")
    elif tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous of shape {shape}, got {tuple(t.shape)}")


# the update's u vector, one buffer per (device, stream): launches on one
# stream run in order, so they can share it
_scratch = {}


def _launch(device, fn, *args):
    """Call a C entry point on the current stream of ``device``, with
    ``device`` current (switched only where it is not already)."""
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(device):
        return fn(*args, stream)


def _u_scratch(device, n: int) -> torch.Tensor:
    key = (device.index, torch._C._cuda_getCurrentRawStream(device.index))
    buf = _scratch.get(key)
    if buf is None or buf.numel() < n:
        buf = _scratch[key] = torch.empty(n, dtype=torch.float32, device=device)
    return buf


def ihb_update_(N, q, btb, ell, active: Optional[torch.Tensor] = None, *, out=None):
    """Theorem 4.9 update of ``N`` in place; returns ``N``.

    ``btb`` (float32), ``ell`` (int32) and ``active`` (bool, optional) are
    one-element tensors on the card.  With ``active`` false the launch moves
    no byte.  With ``out`` the update reads ``N`` and writes ``out`` instead
    (only the leading ``(ell+1)^2`` block of ``out`` is written; the rest is
    left as it is), and returns ``out``.
    """
    device = N.device
    if device.type != "cuda":
        raise ValueError(f"ihb_update kernel needs CUDA tensors, got {device}")
    L = N.shape[0]
    _check("N", N, torch.float32, device, (L, L))
    _check("q", q, torch.float32, device, (L,))
    _check("btb", btb, torch.float32, device)
    _check("ell", ell, torch.int32, device)
    if active is not None:
        _check("active", active, torch.bool, device)
    if out is None:
        out = N
    else:
        _check("out", out, torch.float32, device, (L, L))
    err = _launch(device, _build.library().repro_ihb_update,
                  N.data_ptr(), out.data_ptr(), q.data_ptr(), btb.data_ptr(),
                  ell.data_ptr(), active.data_ptr() if active is not None else None,
                  _u_scratch(device, L).data_ptr(), L)
    _build.check(err, "ihb_update")
    launches["ihb_update"] += 1
    return out


def ihb_degree(QLt, C, N, ell0: int, psi: float, K: int):
    """The candidate loop of one degree in one launch; ``N`` in place.

    ``QLt`` is the normalized ``QL`` transposed, ``(Kcap, Lcap)``; ``C`` the
    normalized ``(Kcap, Kcap)`` Gram of the candidates.  Needs
    ``ell0 + K <= Lcap``.  Returns ``(accepted (K,) bool, mses (K,),
    coeffs (K, Lcap), slots (K,) int64, ell (1,) int32)`` on the card.
    """
    device = N.device
    if device.type != "cuda":
        raise ValueError(f"ihb_degree kernel needs CUDA tensors, got {device}")
    Lcap = N.shape[0]
    Kcap = C.shape[0]
    _check("N", N, torch.float32, device, (Lcap, Lcap))
    _check("QLt", QLt, torch.float32, device, (Kcap, Lcap))
    _check("C", C, torch.float32, device, (Kcap, Kcap))
    if not (1 <= ell0 and 1 <= K <= Kcap and ell0 + K <= Lcap):
        raise ValueError(f"need 1 <= ell0, 1 <= K <= Kcap and ell0 + K <= Lcap, got "
                         f"ell0={ell0}, K={K}, Kcap={Kcap}, Lcap={Lcap}")
    accepted = torch.empty(K, dtype=torch.bool, device=device)
    mses = torch.empty(K, dtype=torch.float32, device=device)
    coeffs = torch.zeros((K, Lcap), dtype=torch.float32, device=device)
    slots = torch.empty(K, dtype=torch.int64, device=device)
    ell = torch.empty(1, dtype=torch.int32, device=device)
    err = _launch(device, _build.library().repro_ihb_degree,
                  QLt.data_ptr(), C.data_ptr(), N.data_ptr(), Lcap, Kcap, ell0, K,
                  ctypes.c_float(psi), accepted.data_ptr(), mses.data_ptr(),
                  coeffs.data_ptr(), slots.data_ptr(), ell.data_ptr(),
                  _u_scratch(device, 2 * Lcap).data_ptr())
    _build.check(err, "ihb_degree")
    launches["ihb_degree"] += 1
    return accepted, mses, coeffs, slots, ell
