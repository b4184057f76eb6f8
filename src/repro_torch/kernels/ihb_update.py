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

:func:`ihb_update_batched_` and :func:`ihb_degree_batched` take k classes on
a leading axis (the class-batched fit) in one cooperative launch; each lane
gives the bits of the one-class call (no bit depends on the blocks a lane is
given).  More classes than one launch holds (:func:`max_lanes`) go in
consecutive launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

# kernel launches made through these wrappers (a class-batched launch counts
# one for all its classes)
launches = {"ihb_update": 0, "ihb_degree": 0, "ihb_update_batched": 0,
            "ihb_degree_batched": 0}


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
                  _u_scratch(device, L).data_ptr(), L, 1)
    _build.check(err, "ihb_update")
    launches["ihb_update"] += 1
    return out


def max_lanes() -> int:
    """Classes one batched launch takes at most (each needs a block of its
    own, every block co-resident on the card)."""
    return int(_build.library().repro_ihb_max_lanes())


def lane_blocks(rows: int, lanes: int) -> int:
    """Blocks each lane of a launch of ``lanes`` lanes is given when its
    largest active block has ``rows`` rows (a one-class call is ``lanes=1``)."""
    return int(_build.library().repro_ihb_lane_blocks(rows, lanes))


def degree_staged(ell0: int, K: int, rows_max: int, lanes: int) -> bool:
    """Whether a lane of :func:`ihb_degree_batched` (``ell0``, ``K``) stages
    its rows of N in shared memory, in a launch of ``lanes`` lanes whose
    largest ``ell0 + K`` is ``rows_max`` (else they stay in device memory)."""
    return bool(_build.library().repro_ihb_degree_staged(ell0 + K, K, rows_max, lanes))


def _chunks(k: int):
    step = max_lanes()
    return [(c, min(c + step, k)) for c in range(0, k, step)]


def ihb_update_batched_(N, q, btb, ell, active: Optional[torch.Tensor] = None):
    """:func:`ihb_update_` for k classes: ``N (k, L, L)`` in place, ``q (k,
    L)``, ``btb (k,)`` float32, ``ell (k,)`` int32 and ``active (k,)`` bool
    (optional) on the card.  An inactive lane moves no byte."""
    device = N.device
    if device.type != "cuda":
        raise ValueError(f"ihb_update kernel needs CUDA tensors, got {device}")
    if N.dim() != 3:
        raise ValueError(f"N must be (k, L, L), got {tuple(N.shape)}")
    k, L = N.shape[0], N.shape[-1]
    _check("N", N, torch.float32, device, (k, L, L))
    _check("q", q, torch.float32, device, (k, L))
    _check("btb", btb, torch.float32, device, (k,))
    _check("ell", ell, torch.int32, device, (k,))
    if active is not None:
        _check("active", active, torch.bool, device, (k,))
    lib = _build.library()
    u = _u_scratch(device, k * L)
    for c0, c1 in _chunks(k):
        err = _launch(device, lib.repro_ihb_update,
                      N[c0].data_ptr(), N[c0].data_ptr(), q[c0].data_ptr(),
                      btb[c0:].data_ptr(), ell[c0:].data_ptr(),
                      active[c0:].data_ptr() if active is not None else None,
                      u.data_ptr(), L, c1 - c0)
        _build.check(err, "ihb_update (batched)")
        launches["ihb_update_batched"] += 1
    return N


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
    one = (ctypes.c_int * 1)
    err = _launch(device, _build.library().repro_ihb_degree,
                  QLt.data_ptr(), C.data_ptr(), N.data_ptr(), Lcap, Kcap, one(ell0),
                  one(K), 1, K, ctypes.c_float(psi), accepted.data_ptr(), mses.data_ptr(),
                  coeffs.data_ptr(), slots.data_ptr(), ell.data_ptr(),
                  _u_scratch(device, 2 * Lcap).data_ptr())
    _build.check(err, "ihb_degree")
    launches["ihb_degree"] += 1
    return accepted, mses, coeffs, slots, ell


def ihb_degree_batched(QLt, C, N, ell0s, psi: float, Ks):
    """:func:`ihb_degree` for k classes in one launch: ``QLt (k, Kcap,
    Lcap)``, ``C (k, Kcap, Kcap)``, ``N (k, Lcap, Lcap)`` in place, and per
    class its ``ell0s[c]`` and ``Ks[c]`` candidates (host ints; 0 for a class
    that has none this degree).  Returns ``(accepted (k, Kmax), mses (k,
    Kmax), coeffs (k, Kmax, Lcap), slots (k, Kmax), ell (k,))`` with ``Kmax =
    max(Ks)``; entries past a class's own K are False, 0, 0 and ``Lcap``."""
    device = N.device
    if device.type != "cuda":
        raise ValueError(f"ihb_degree kernel needs CUDA tensors, got {device}")
    if N.dim() != 3:
        raise ValueError(f"N must be (k, Lcap, Lcap), got {tuple(N.shape)}")
    k, Lcap, Kcap = N.shape[0], N.shape[-1], C.shape[-1]
    ell0s, Ks = [int(e) for e in ell0s], [int(x) for x in Ks]
    _check("N", N, torch.float32, device, (k, Lcap, Lcap))
    _check("QLt", QLt, torch.float32, device, (k, Kcap, Lcap))
    _check("C", C, torch.float32, device, (k, Kcap, Kcap))
    Kmax = max(Ks, default=0)
    if len(ell0s) != k or len(Ks) != k or Kmax < 1 or not all(
            1 <= e and 0 <= x <= Kcap and e + x <= Lcap for e, x in zip(ell0s, Ks)):
        raise ValueError(f"need k = {k} pairs with 1 <= ell0, 0 <= K <= Kcap, "
                         f"ell0 + K <= Lcap and some K >= 1, got {ell0s}, {Ks}")
    accepted = torch.zeros((k, Kmax), dtype=torch.bool, device=device)
    mses = torch.zeros((k, Kmax), dtype=torch.float32, device=device)
    coeffs = torch.zeros((k, Kmax, Lcap), dtype=torch.float32, device=device)
    slots = torch.full((k, Kmax), Lcap, dtype=torch.int64, device=device)
    ell = torch.empty(k, dtype=torch.int32, device=device)
    lib = _build.library()
    u = _u_scratch(device, 2 * k * Lcap)
    for c0, c1 in _chunks(k):
        n = c1 - c0
        if max(Ks[c0:c1]) == 0:  # no candidates in this chunk: nothing moves
            ell[c0:c1] = torch.tensor(ell0s[c0:c1], dtype=torch.int32)
            continue
        err = _launch(device, lib.repro_ihb_degree,
                      QLt[c0].data_ptr(), C[c0].data_ptr(), N[c0].data_ptr(), Lcap, Kcap,
                      (ctypes.c_int * n)(*ell0s[c0:c1]), (ctypes.c_int * n)(*Ks[c0:c1]), n,
                      Kmax, ctypes.c_float(psi), accepted[c0].data_ptr(), mses[c0].data_ptr(),
                      coeffs[c0].data_ptr(), slots[c0].data_ptr(), ell[c0:].data_ptr(),
                      u.data_ptr())
        _build.check(err, "ihb_degree (batched)")
        launches["ihb_degree_batched"] += 1
    return accepted, mses, coeffs, slots, ell
