"""Inverse Hessian Boosting (IHB) — Section 4.4 / Theorem 4.9.

Counterpart of ``src/repro/core/ihb.py``.  OAVI solves a sequence of
least-squares problems ``min_y ||A y + b||^2`` in which ``A = O(X)`` grows by
one column whenever a border term is appended to ``O``.  IHB maintains
``N = (A^T A)^{-1}`` across appends with the block inverse update of Theorem
4.9 in ``O(l^2)`` operations, so the closed-form optimum ``y* = -N A^T b`` is
available essentially for free.

All state is fixed-capacity: ``N`` is ``(L, L)`` with the *inactive* block set
to the identity (so the padded ``N`` is the exact inverse of the padded
``A^T A + I_inactive``).  Each factor (``AtA`` for the convex oracles, ``N``
for the Theorem 4.9 inverse, ``R`` for the Cholesky engine) is kept and
updated only when the configured engine needs it (:func:`factors_for`).

The ``N`` update goes through :func:`repro_torch.kernels.ops.ihb_update_`, in
place: the CUDA kernel on the card, its plain PyTorch version on the CPU.
Every update takes ``ell``, ``btb`` and an optional ``active`` flag as device
tensors, so a candidate loop runs without a host sync per candidate.  The fast
engine's own candidate loop runs through ``ops.ihb_degree`` instead
(:func:`repro_torch.core.oavi.stats_step`), one launch per degree on the card.

A class axis (the class-batched fit, :mod:`repro_torch.core.class_batch`):
every factor may carry a leading axis of k classes, ``(k, L, L)``, with
``q (k, L)`` and ``btb``/``ell``/``active (k,)``.  Each class's slice is
updated exactly as the one-class state would be (the same elementwise
operations, and ``ops.ihb_update_batched_``: one launch for every class on
the card), and an inactive class's slice is left bit for bit as it was.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..kernels import ops as kernel_ops


class IHBState(NamedTuple):
    """Per-factor state; a factor the engine does not need is ``None``.
    Each factor is ``(L, L)``, or ``(k, L, L)`` with a class axis."""

    AtA: Optional[torch.Tensor]  # (L, L) Gram of active columns (zeros elsewhere)
    N: Optional[torch.Tensor]  # (L, L) inverse of (AtA_active ⊕ I_inactive)
    R: Optional[torch.Tensor]  # (L, L) upper-triangular Cholesky factor (ditto)


FACTORS_ALL: Tuple[str, ...] = ("ata", "n", "r")


def factors_for(
    engine: str,
    inverse_engine: str = "inverse",
    warm: bool = True,
    wihb: bool = False,
):
    """Minimal factor set for an OAVI configuration.

    * ``AtA`` — needed only as a solver Hessian: by the convex oracles
      (``engine='oracle'``) and by the WIHB sparse re-solve (``wihb``).
    * ``N`` / ``R`` — one of them backs the closed-form optimum: always for
      ``engine='fast'``, and for the oracle engine only with IHB warm starts.
    """
    need = []
    if engine == "oracle" or wihb:
        need.append("ata")
    if engine == "fast" or warm:
        need.append("r" if inverse_engine == "chol" else "n")
    return tuple(need)


def init_state(Lcap: int, diag0: float, dtype=torch.float32,
               factors: Tuple[str, ...] = FACTORS_ALL,
               device=None, classes: Optional[int] = None) -> IHBState:
    """State after the constant-1 column: ``AtA[0, 0] = ||1||^2`` (= 1 in the
    normalized Gram convention).  ``classes=k`` gives every factor a leading
    axis of k identical classes."""
    diag0 = float(diag0)
    lead = () if classes is None else (int(classes),)
    AtA = N = R = None
    if "ata" in factors:
        AtA = torch.zeros(lead + (Lcap, Lcap), dtype=dtype, device=device)
        AtA[..., 0, 0] = diag0
    if "n" in factors:
        N = torch.eye(Lcap, dtype=dtype, device=device).repeat(lead + (1, 1))
        N[..., 0, 0] = 1.0 / diag0
    if "r" in factors:
        R = torch.eye(Lcap, dtype=dtype, device=device).repeat(lead + (1, 1))
        R[..., 0, 0] = diag0 ** 0.5
    return IHBState(AtA=AtA, N=N, R=R)


def grow_state(state: IHBState, new_L: int) -> IHBState:
    """Double capacity: each present factor is embedded into its padded
    identity (``N``, ``R``) or zero (``AtA``) block."""

    def embed(M, identity: bool):
        if M is None:
            return None
        L = M.shape[-1]
        lead = tuple(M.shape[:-2])
        if identity:
            base = torch.eye(new_L, dtype=M.dtype, device=M.device).repeat(lead + (1, 1))
        else:
            base = torch.zeros(lead + (new_L, new_L), dtype=M.dtype, device=M.device)
        base[..., :L, :L] = M
        return base

    return IHBState(
        AtA=embed(state.AtA, identity=False),
        N=embed(state.N, identity=True),
        R=embed(state.R, identity=True),
    )


def closed_form_inverse(state: IHBState, q: torch.Tensor) -> torch.Tensor:
    """``y* = -N q`` (the paper's IHB optimum).  ``q = A^T b`` padded; with a
    class axis each class's product is its own ``mv`` (a batched product
    need not give each slice's bits)."""
    if q.dim() == 1:
        return -(state.N @ q)
    return -torch.stack([state.N[c] @ q[c] for c in range(q.shape[0])])


def closed_form_cholesky(state: IHBState, q: torch.Tensor) -> torch.Tensor:
    """``y* = -(R^T R)^{-1} q`` via two triangular solves (beyond-paper)."""
    z = torch.linalg.solve_triangular(state.R.mT, q[:, None], upper=False)
    return -torch.linalg.solve_triangular(state.R, z, upper=True)[:, 0]


def append_column(
    state: IHBState,
    q: torch.Tensor,  # (L,) A^T b for the new column b (zeros at inactive idx)
    btb,  # ||b||^2, a number or a one-element tensor
    ell,  # current active count == index where b lands (int or device tensor)
    active: Optional[torch.Tensor] = None,  # bool tensor: False keeps the state
) -> IHBState:
    """Theorem 4.9 block inverse update + Cholesky append, both O(l^2).

    Only the factors present in ``state`` are updated (``None`` stays
    ``None``).  With ``active`` false every factor comes back unchanged.
    ``N`` is updated in place (the returned state holds the same tensor);
    ``AtA`` and ``R`` are new tensors.  With a class axis (``q (k, L)``;
    ``btb``, ``ell`` and ``active`` of shape ``(k,)``) each class is updated
    as alone; ``R`` (the Cholesky engine) has none.
    """
    lead = tuple(q.shape[:-1])
    ell_t = torch.as_tensor(ell, dtype=torch.int32, device=q.device).reshape(lead)
    if state.AtA is not None or state.R is not None:
        onehot = (torch.arange(q.shape[-1], device=q.device)
                  == ell_t.unsqueeze(-1)).to(q.dtype)
        keep = 1.0 - onehot

    def gate(new, old):
        if active is None:
            return new
        return torch.where(active.reshape(active.shape + (1, 1)), new, old)

    AtA = N = R = None

    if state.AtA is not None:
        # add row/col ell = (q, btb); the outer products are elementwise
        btb_t = torch.as_tensor(btb, dtype=q.dtype, device=q.device)
        AtA = gate(
            state.AtA
            + onehot.unsqueeze(-1) * q.unsqueeze(-2)
            + q.unsqueeze(-1) * onehot.unsqueeze(-2)
            + btb_t.reshape(btb_t.shape + (1, 1)) * (onehot.unsqueeze(-1) * onehot.unsqueeze(-2)),
            state.AtA,
        )

    if state.N is not None:
        # inverse update (Thm 4.9), in place: the CUDA kernel on the card,
        # its plain version on the CPU
        if lead:
            N = kernel_ops.ihb_update_batched_(state.N, q, btb, ell_t, active=active)
        else:
            N = kernel_ops.ihb_update_(state.N, q, btb, ell_t, active=active)

    if state.R is not None:
        # Cholesky append: R^T r = q ; rho = sqrt(btb - r^T r)
        r = torch.linalg.solve_triangular(state.R.mT, q[:, None], upper=False)[:, 0]
        r = r * keep  # the inactive identity block must not leak into r
        rho2 = torch.clamp(btb - torch.dot(r, r), min=1e-30)
        col = r + torch.sqrt(rho2) * onehot
        # overwrite column ell of R (previously e_ell from the identity padding)
        R = gate(state.R * keep[None, :] + torch.outer(col, onehot), state.R)

    return IHBState(AtA=AtA, N=N, R=R)
