"""Launcher of the hand-written CUDA FISTA step (``csrc/fista_step.cu``).

One step of the l1 squared-hinge head's FISTA loop (``core/svm.py``) is one
launch: the gradient in one pass over X, the block partials summed by the
last block in a fixed order, and the prox, momentum, extrapolation, stop
test and step count on a state buffer on the card.  It replaces no Pallas
kernel (the JAX package's loop is a ``lax.while_loop`` that XLA fuses).

:class:`FistaStep` holds one fit's state and launches ``n`` steps at a time
without a host sync.  On CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref.fista_step_ref`, which mirrors the kernel's
arithmetic (the class index for the +-1 targets, block partials summed in
block order in float64).  :func:`takes` says which heads the kernel takes:
a float32 head on the card whose ``p`` features and ``k`` classes fit one of
the kernel's instantiations (:func:`variant`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build, ref
from .ihb_update import _check, _launch

# p rounded up to one of P_BUCKETS and k to one of K_BUCKETS, their product at
# most ACC_LIMIT: the accumulators each thread keeps in registers
# (csrc/fista_step.cu's instantiations)
P_BUCKETS = (4, 8, 16, 32)
K_BUCKETS = (2, 4, 8)
ACC_LIMIT = 64
# blocks of the plain version's partials (the card's come from its SM count)
REF_BLOCKS = 4

launches = {"fista_step": 0}


def variant(p: int, k: int) -> Optional[Tuple[int, int]]:
    """The kernel's instantiation ``(PB, KB)`` for a head of ``p`` features
    and ``k`` classes, or None where none takes it."""
    pb = next((b for b in P_BUCKETS if p <= b), None)
    kb = next((b for b in K_BUCKETS if k <= b), None)
    if p < 1 or k < 1 or pb is None or kb is None or pb * kb > ACC_LIMIT:
        return None
    return pb, kb


def takes(device, dtype, p: int, k: int) -> bool:
    """Whether a head on ``device`` of ``dtype`` with ``p`` features and
    ``k`` classes runs through the kernel (else the eager step)."""
    return (torch.device(device).type == "cuda" and dtype == torch.float32
            and variant(p, k) is not None)


class FistaStep:
    """One fit's FISTA state, stepped by the kernel (CUDA tensors) or its
    plain version (CPU tensors).

    ``X (m, p)`` float32 and ``labels (m,)`` int8 class indices in
    ``[0, k)``, both contiguous on one device (on the card both 16-byte
    aligned); ``step``, ``lam`` and ``tol`` one-element float32 tensors there.  The state starts at W = Wz = 0, b =
    bz = 0, t = 1, delta = inf, ``iters`` 0.
    """

    def __init__(self, X, labels, k: int, step, lam, tol, max_iter: int):
        device = X.device
        if X.dim() != 2 or X.shape[0] < 1:
            raise ValueError(f"X must be (m, p) with m >= 1, got {tuple(X.shape)}")
        m, p = X.shape
        if variant(p, k) is None:
            raise ValueError(f"no instantiation of the FISTA step takes p={p}, k={k}")
        _check("X", X, torch.float32, device, (m, p))
        _check("labels", labels, torch.int8, device, (m,))
        for name, t in (("step", step), ("lam", lam), ("tol", tol)):
            _check(name, t, torch.float32, device)
        self.X, self.labels, self.k, self.max_iter = X, labels, k, int(max_iter)
        self.step, self.lam, self.tol = step, lam, tol
        self.state = X.new_zeros(2 * p * k + 2 * k + 2)
        self.state[-2] = 1.0
        self.state[-1] = float("inf")
        self.iters = torch.zeros(1, dtype=torch.int32, device=device)
        self.W, self.b, _, _, _, self.delta = ref.fista_state_views(self.state, p, k)
        self.on_card = device.type == "cuda"
        if self.on_card:
            if X.data_ptr() % 16 or labels.data_ptr() % 16:
                raise ValueError("the kernel copies X and labels in 16-byte chunks: both "
                                 "must start 16-byte aligned")
            self.grid = int(_build.library().repro_fista_grid(m, p, k))
            if self.grid < 1:
                raise RuntimeError(f"fista_step: no grid for m={m}, p={p}, k={k}")
            self.partials = torch.empty((p * k + k) * self.grid, dtype=torch.float32,
                                        device=device)
            self.ticket = torch.zeros(1, dtype=torch.int32, device=device)
            self._args = (X.data_ptr(), labels.data_ptr(), self.state.data_ptr(),
                          self.iters.data_ptr(), self.partials.data_ptr(),
                          self.ticket.data_ptr(), step.data_ptr(), lam.data_ptr(),
                          tol.data_ptr(), m, p, k, self.max_iter, ctypes.c_float(-2.0 / m),
                          self.grid)

    def run(self, steps: int) -> None:
        """Issue ``steps`` steps; those past the stop change nothing."""
        if not self.on_card:
            for _ in range(steps):
                ref.fista_step_ref(self.X, self.labels, self.state, self.iters, self.step,
                                   self.lam, self.tol, self.max_iter, blocks=REF_BLOCKS)
            return
        err = _launch(self.X.device, _build.library().repro_fista_steps, *self._args, steps)
        _build.check(err, "fista_step")
        launches["fista_step"] += steps
