"""ABM: the Approximate Buchberger-Möller algorithm (Limbeck 2013).

Counterpart of ``src/repro/core/abm.py``, the paper's baseline of Section 6.
The border machinery is OAVI's (term book, DegLex borders, Pearson
ordering), but each border term is decided by an eigendecomposition of the
*extended* Gram matrix ``[[A^T A, A^T b], [b^T A, b^T b]] / m``: its smallest
eigenvalue is the least MSE of any unit-norm polynomial over ``O ∪ {u}``,
and its eigenvector gives the coefficients.  A border term becomes a
generator iff ``lambda_min <= psi``; its coefficients are rescaled so that
the leading term's is 1 (monic), OAVI's convention for the transform.

Per degree:

1.  ``QL = A^T B / m`` and ``C = B^T B / m`` of the candidate columns
    ``B = A[:, parents] * X[:, vars]`` through
    :func:`repro_torch.kernels.ops.gram_update`: the hand-written CUDA
    kernel on the card (kernel 3, the Pallas ``gram_update`` without a
    carry), its plain version on the CPU.  The kernel takes float32 only, so
    a float64 fit on the card raises, as the port's OAVI fit does there.
2.  A host loop over the K candidates, in order: the extended Gram with the
    candidate at slot ``ell`` (the inactive block's diagonal set to 2, so a
    padded eigenvalue is never the least), one ``torch.linalg.eigh`` on the
    fit's device, and the verdict read on the host; a rejected candidate's
    row and column are written into ``A^T A``.
3.  The appended candidate columns are written into ``A``.

Each ``eigh`` and each verdict is a host sync.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from .. import _device
from ..kernels import ops as kernel_ops
from . import terms as terms_mod
from .oavi import Generator, OAVIModel, border_index_arrays, collect_degree
from .ordering import pearson_order


@dataclasses.dataclass(frozen=True)
class ABMConfig:
    psi: float = 0.005
    max_degree: int = 10
    cap_terms: int = 256
    cap_border: int = 64
    dtype: str = "float32"
    ordering: str = "pearson"


def candidate_loop(AtA, QL, C, ell0: int, K: int, psi: float):
    """The K candidates of one degree, in order, from the normalized Gram
    blocks (the reference's ``fori_loop`` body).  ``AtA`` (Lcap, Lcap) is
    updated in place with every rejected candidate.

    Returns host arrays ``(accepted, lams, coeffs, slots)``: ``coeffs[a]``
    holds the non-leading monic coefficients over slots ``< ell`` of an
    accepted candidate, ``slots[a]`` the slot of an appended one (Lcap
    otherwise).
    """
    Lcap = AtA.shape[0]
    dev = AtA.device
    np_dtype = AtA.new_zeros(()).cpu().numpy().dtype
    psi = float(np_dtype.type(psi))  # psi rounded to the working dtype
    ell = ell0
    accepted = np.zeros((K,), bool)
    lams = np.zeros((K,), np.float64)
    coeffs = np.zeros((K, Lcap), np_dtype)
    slots = np.full((K,), Lcap, np.int64)
    eye2 = 2.0 * torch.eye(Lcap, dtype=AtA.dtype, device=dev)
    for a in range(K):
        q = QL[:, a].clone()
        before = np.nonzero(slots[:a] < Lcap)[0]
        if before.size:
            # the columns appended earlier in this degree are not in A yet:
            # their products with this candidate come from C
            at = torch.as_tensor(slots[before], device=dev)
            q.index_put_((at,), q[at] + C[torch.as_tensor(before, device=dev), a])
        # extended Gram, candidate at slot ell; column ell of A and every
        # later one are still zero, so q[ell:] == 0 and AtA[ell:, :] == 0
        # and the reference's additive build gives exactly these entries
        M = eye2.clone()
        M[:ell, :ell] = AtA[:ell, :ell]
        M[ell, :ell] = q[:ell]
        M[:ell, ell] = q[:ell]
        M[ell, ell] = C[a, a]
        evals, evecs = torch.linalg.eigh(M)
        lam = float(evals[0])
        v = evecs[: ell + 1, 0]
        lead = v[ell]
        lead = torch.where(torch.abs(lead) > 1e-12, lead, torch.full_like(lead, 1e-12))
        lams[a] = lam
        if lam <= psi:
            accepted[a] = True
            coeffs[a, :ell] = (v[:ell] / lead).cpu().numpy()
        else:
            AtA[ell, :ell] = q[:ell]
            AtA[:ell, ell] = q[:ell]
            AtA[ell, ell] = C[a, a]
            slots[a] = ell
            ell += 1
    return accepted, lams, coeffs, slots


def fit(X, config: ABMConfig = ABMConfig(), *, device=None) -> OAVIModel:
    """Run ABM on ``X`` (m, n) in [0,1]^n.  ``device=None`` means the CUDA
    card (and raises without one); pass ``device="cpu"`` for the CPU."""
    dev = _device.resolve(device)
    dtype = getattr(torch, config.dtype)
    t0 = time.perf_counter()
    launches0 = kernel_ops.launch_counts()
    X = np.asarray(X)
    m, n = X.shape

    perm = None
    if config.ordering in ("pearson", "reverse_pearson"):
        perm = pearson_order(X, reverse=(config.ordering == "reverse_pearson"))
        X = X[:, perm]

    Xd = _device.tensor(X, dtype, dev)
    book = terms_mod.TermBook(n=n)
    generators: List[Generator] = []

    Lcap = int(config.cap_terms)
    A = torch.zeros((m, Lcap), dtype=dtype, device=dev)
    A[:, 0] = 1.0
    AtA = torch.zeros((Lcap, Lcap), dtype=dtype, device=dev)
    AtA[0, 0] = 1.0
    ell = 1
    # 1/m rounded once in the working dtype, as the reference does
    inv_m = torch.tensor(1.0 / m, dtype=dtype, device=dev)
    stats: Dict = {"border_sizes": [], "degrees": [], "m": m, "n": n,
                   "eigh_calls": 0}

    d = 0
    while True:
        d += 1
        if d > config.max_degree:
            stats["termination"] = "max_degree"
            break
        border = book.border(d)
        if not border:
            stats["termination"] = "empty_border"
            break
        K = len(border)
        stats["border_sizes"].append(K)
        stats["degrees"].append(d)
        if ell + K > Lcap:
            raise RuntimeError("ABM capacity exhausted; raise cap_terms")

        Kcap = max(config.cap_border, 1 << (K - 1).bit_length())
        parents, vars_, _ = border_index_arrays(book, border, Kcap)
        p_t = torch.as_tensor(parents, device=dev)
        v_t = torch.as_tensor(vars_, device=dev)
        QL, C = kernel_ops.gram_update(A, Xd, p_t, v_t)
        QL, C = QL * inv_m, C * inv_m
        accepted, lams, coeffs, slots = candidate_loop(AtA, QL, C, ell, K, config.psi)
        stats["eigh_calls"] += K
        idx = np.nonzero(slots < Lcap)[0]
        if idx.size:
            sel = torch.as_tensor(idx, device=dev)
            A.index_copy_(1, torch.as_tensor(slots[idx], device=dev),
                          A[:, p_t[sel]] * Xd[:, v_t[sel]])
        ell = collect_degree(book, border, accepted, lams, coeffs, generators)

    launches1 = kernel_ops.launch_counts()
    stats["kernel_launches"] = {k: launches1[k] - launches0[k] for k in launches1}
    stats["time_total"] = time.perf_counter() - t0
    stats["num_G"] = len(generators)
    stats["num_O"] = len(book)
    stats["G_plus_O"] = len(generators) + len(book)
    return OAVIModel(
        n=n, psi=config.psi, book=book, generators=generators,
        feature_perm=perm, stats=stats, dtype=config.dtype, device=dev,
    )
