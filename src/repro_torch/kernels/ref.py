"""Plain PyTorch versions of the Pallas kernels' semantics.

Counterparts of ``src/repro/kernels/ref.py``.  The CPU path of
:mod:`repro_torch.kernels.ops` runs these, the tests hold them against the
JAX package's references, and ``chip_smoke.py`` holds the CUDA kernels
against them on the card.  Matrix products here are full fp32 only while
``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default); a
comparison with the kernels, which never use TF32, sets it so itself.
"""

from __future__ import annotations

import torch


def border_columns_ref(A, X, parents, vars_):
    """Candidate columns ``B = A[:, parents] * X[:, vars]`` by direct gather."""
    return A.index_select(1, parents) * X.index_select(1, vars_)


def gram_update_gather_ref(A, X, parents, vars_):
    """``(A^T B, B^T B)`` with the candidate columns built by gather."""
    B = border_columns_ref(A, X, parents, vars_)
    return A.T @ B, B.T @ B


def gram_accumulate_ref(A, X, parents, vars_, ql0, c0, *, bm: int):
    """Blocked carry-in Gram reduction in the canonical order: both Grams of
    every ``bm``-row block (one batched product), then the block partials
    folded onto ``(ql0, c0)`` strictly left to right.

    Each block's partial depends on that block's rows alone, so chaining calls
    over row chunks that are multiples of ``bm`` gives the same bits as one
    call.  ``A.shape[0]`` must be a multiple of ``bm`` (ops pads with zero
    rows, which add exact zeros: every OAVI value is >= +0.0).
    """
    m, L = A.shape
    nb = m // bm
    B = border_columns_ref(A, X, parents, vars_)
    Ab = A.reshape(nb, bm, L)
    Bb = B.reshape(nb, bm, B.shape[1])
    QLb = torch.bmm(Ab.transpose(1, 2), Bb)
    Cb = torch.bmm(Bb.transpose(1, 2), Bb)
    ql, c = ql0, c0
    for b in range(nb):
        ql = ql + QLb[b]
        c = c + Cb[b]
    return ql, c


def ihb_update_ref(N, q, btb, ell, active=None):
    """Theorem 4.9 block-inverse update on the padded inverse (identity in the
    inactive block); mirrors ``repro.kernels.ref.ihb_update_ref``.

    Contract: ``q`` is zero at slot ``ell`` and beyond, and row/column ``ell``
    of ``N`` is its identity row, so ``u[ell] = 0``.  The Schur complement
    reduces as ``sum(q * u)``.  ``ell``, ``btb`` and ``active`` may be device
    tensors (no host sync); ``active`` false returns ``N`` unchanged.
    """
    L = N.shape[0]
    dtype = N.dtype
    ell_t = torch.as_tensor(ell, device=N.device).reshape(1).long()
    onehot = (torch.arange(L, device=N.device) == ell_t).to(dtype)
    keep = 1.0 - onehot
    u = N @ q
    s = torch.clamp(btb - torch.sum(q * u), min=1e-30)
    n2 = -u / s
    P = N + torch.outer(u, u) / s
    colrow = n2 * keep + onehot / s  # new row & column ell (diag = 1/s)
    P = P.index_copy(1, ell_t, colrow[:, None])
    P = P.index_copy(0, ell_t, colrow[None, :])
    if active is not None:
        P = torch.where(active, P, N)
    return P


def ihb_degree_ref(QLt, C, N, ell0: int, psi, K: int):
    """The fast engine's candidate loop of one degree, ``inverse_engine=
    'inverse'`` (the reference's ``_make_stats_degree_step``), in eager ops.

    ``QLt`` is the normalized ``QL`` transposed, ``(Kcap, Lcap)``; ``C`` the
    normalized ``(Kcap, Kcap)`` candidate Gram.  Candidate ``a``'s ``A^T b``
    vector is ``QL[:, a]`` plus ``C[j, a]`` scattered into the slots of the
    candidates ``j < a`` appended earlier; ``y = -N q`` on the active block,
    ``mse = btb + sum(q * y)``; a candidate with ``mse > psi`` is appended at
    slot ``ell`` by :func:`ihb_update_ref`.  Every decision stays on the
    device (the append is gated by a device flag), so the loop never syncs
    with the host.  ``N`` is updated in place.  Returns ``(accepted, mses,
    coeffs (K, Lcap), slots, ell)`` as device tensors.
    """
    dev, dtype = N.device, N.dtype
    Lcap = N.shape[0]
    Kcap = C.shape[0]
    # one trash row at index Lcap absorbs the scatter of candidates that were
    # not appended, so the scatter below needs no host-side mask
    QLx = torch.cat([QLt.T, QLt.new_zeros((1, Kcap))], dim=0)
    psi = torch.tensor(psi, dtype=dtype, device=dev)
    ar = torch.arange(Lcap, device=dev)
    ell = torch.tensor(ell0, dtype=torch.int32, device=dev)
    slots = torch.full((K,), Lcap, dtype=torch.long, device=dev)
    accepted = torch.zeros((K,), dtype=torch.bool, device=dev)
    coeffs = torch.zeros((K, Lcap), dtype=dtype, device=dev)
    mses = torch.zeros((K,), dtype=dtype, device=dev)
    no_slot = torch.tensor(Lcap, dtype=torch.long, device=dev)

    for a in range(K):
        q = QLx[:, a].clone()
        if a > 0:
            # correction for the columns appended earlier in this degree; the
            # slots are distinct, so the scatter is deterministic
            before = slots[:a]
            q.index_put_((before,), q[before] + C[:a, a])
        q = q[:Lcap]
        btb = C[a, a]
        y0 = -(N @ q)
        y0 = torch.where(ar < ell, y0, 0.0)
        # sum(q * y0), the reduction the reference uses
        mse0 = btb + torch.sum(q * y0)
        accept = mse0 <= psi
        # on reject: append the column to O (slot = ell) and update N
        do_append = ~accept
        N.copy_(ihb_update_ref(N, q, btb, ell, do_append))
        slots[a] = torch.where(do_append, ell.long(), no_slot)
        ell = ell + do_append.to(torch.int32)
        accepted[a] = accept
        coeffs[a] = torch.where(accept, y0, 0.0)
        mses[a] = mse0
    return accepted, mses, coeffs, slots, ell.reshape(1)


def gram_accumulate_batched_ref(A, X, parents, vars_, ql0, c0, *, bm: int):
    """:func:`gram_accumulate_ref` of every class of a leading class axis,
    one class after another: each class's bits are its own call's."""
    outs = [gram_accumulate_ref(A[c], X[c], parents[c], vars_[c], ql0[c], c0[c], bm=bm)
            for c in range(A.shape[0])]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def ihb_update_batched_ref(N, q, btb, ell, active=None):
    """:func:`ihb_update_ref` of every class of a leading class axis (``N (k,
    L, L)``, ``q (k, L)``, ``btb``/``ell``/``active (k,)``), one class after
    another; returns the new ``(k, L, L)``."""
    return torch.stack([
        ihb_update_ref(N[c], q[c], btb[c], ell[c], None if active is None else active[c])
        for c in range(N.shape[0])
    ])


def ihb_degree_batched_ref(QLt, C, N, ell0s, psi, Ks):
    """:func:`ihb_degree_ref` of every class of a leading class axis, one
    class after another (``N (k, Lcap, Lcap)`` in place; a class with
    ``Ks[c] == 0`` is left alone).  Returns ``(accepted (k, Kmax), mses,
    coeffs (k, Kmax, Lcap), slots, ell (k,))``, ``Kmax = max(Ks)``; entries
    past a class's own K are False, 0, 0 and ``Lcap``."""
    k, Lcap = N.shape[0], N.shape[-1]
    Kmax = max(int(x) for x in Ks)
    dev, dtype = N.device, N.dtype
    accepted = torch.zeros((k, Kmax), dtype=torch.bool, device=dev)
    mses = torch.zeros((k, Kmax), dtype=dtype, device=dev)
    coeffs = torch.zeros((k, Kmax, Lcap), dtype=dtype, device=dev)
    slots = torch.full((k, Kmax), Lcap, dtype=torch.long, device=dev)
    ell = torch.tensor([int(e) for e in ell0s], dtype=torch.int32, device=dev)
    for c in range(k):
        K = int(Ks[c])
        if K == 0:
            continue
        acc, mse, coef, slot, e = ihb_degree_ref(QLt[c], C[c], N[c], int(ell0s[c]), psi, K)
        accepted[c, :K] = acc
        mses[c, :K] = mse
        coeffs[c, :K] = coef
        slots[c, :K] = slot
        ell[c] = e[0]
    return accepted, mses, coeffs, slots, ell


# masked score of the plain version, as in the JAX package (finite, so a
# fully masked row gives a uniform softmax, never NaN)
NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, q_heads_per_kv=1):
    """Dense softmax attention; mirrors ``repro.kernels.ref.attention_ref``.

    ``q (BHq, Sq, d)``; ``k (BHkv, Sk, d)``, ``v (BHkv, Sk, dv)`` with
    ``BHq = BHkv * q_heads_per_kv``.  Scores are the product in the inputs'
    type, then fp32 times ``1/sqrt(d)``; p is cast to v's type before P V; the
    output takes q's type.  Causal needs ``Sq == Sk``: the JAX package's plain
    version masks bottom-right and its kernel top-left, which agree only
    there, and the port computes one function on both paths.
    """
    Sq, d = q.shape[1], q.shape[2]
    Sk = k.shape[1]
    if causal and Sq != Sk:
        raise ValueError(f"causal attention needs Sq == Sk, got {Sq} and {Sk}")
    if q_heads_per_kv != 1:
        k = k.repeat_interleave(q_heads_per_kv, dim=0)
        v = v.repeat_interleave(q_heads_per_kv, dim=0)
    s = torch.einsum("hqd,hkd->hqk", q, k).float() * (1.0 / d**0.5)
    if causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device).tril(Sk - Sq)
        s = s.masked_fill(~mask[None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p.to(v.dtype), v).to(q.dtype)


def fista_update_ref(W, b, Wz, bz, t, gW, gb, step, lam):
    """The FISTA update of the l1 squared-hinge head after its gradient
    ``(gW, gb)`` at ``(Wz, bz)``: the soft-threshold prox with ``step *
    lam``, the unpenalized bias, the momentum and the extrapolation.  Returns
    ``(W', b', Wz', bz', t', delta')`` with ``delta' = max|W' - W| + max|b' -
    b|``.  ``core/svm.py``'s eager step and :func:`fista_step_ref` run it;
    ``csrc/fista_step.cu`` does the same float32 operations in this order."""
    u = Wz - step * gW
    W_new = torch.sign(u) * torch.clamp(torch.abs(u) - step * lam, min=0.0)
    b_new = bz - step * gb  # bias unpenalized
    t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
    beta = (t - 1.0) / t_new
    Wz_new = W_new + beta * (W_new - W)
    bz_new = b_new + beta * (b_new - b)
    d_new = torch.max(torch.abs(W_new - W)) + torch.max(torch.abs(b_new - b))
    return W_new, b_new, Wz_new, bz_new, t_new, d_new


def class_signs_ref(labels, k: int, dtype):
    """One-vs-rest targets from class indices: ``Y[i, c] = +1`` if
    ``labels[i] == c`` else ``-1``, the +-1 matrix ``LinearSVM`` trains on."""
    hit = labels.long()[:, None] == torch.arange(k, device=labels.device)
    return torch.where(hit, 1.0, -1.0).to(dtype)


def fista_state_views(state, p: int, k: int):
    """``(W (p, k), b, Wz (p, k), bz, t, delta)``: views of the fused FISTA
    step's state buffer, laid out ``W | b | Wz | bz | t | delta``."""
    pk = p * k
    return (state[:pk].view(p, k), state[pk:pk + k], state[pk + k:2 * pk + k].view(p, k),
            state[2 * pk + k:2 * pk + 2 * k], state[-2], state[-1])


def fista_step_ref(X, labels, state, iters, step, lam, tol, max_iter: int, *, blocks: int,
                   warps: int = 8, rows: int = 32):
    """One step of ``csrc/fista_step.cu`` in plain PyTorch, on its state
    buffer and its step count (int32, one element) in place.

    The targets come from the class index (:func:`class_signs_ref`).  The
    gradient is summed as the kernel sums it: tiles of ``rows`` rows dealt to
    the ``blocks * warps`` warps of the grid in turn (tile ``i`` to warp ``i %
    (blocks * warps)``, warp ``w`` in block ``w // warps``), one float32
    partial a block, the partials summed in block order in float64.  The
    partials' own sums take the library's order, not the kernel's per-lane
    order.  A step past the stop (``iters >= max_iter`` or ``delta <= tol``)
    changes nothing.
    """
    m, p = X.shape
    k = (state.numel() - 2) // (2 * p + 2)
    W, b, Wz, bz, t, delta = fista_state_views(state, p, k)
    if not bool((iters < max_iter) & (delta > tol)):
        return
    Y = class_signs_ref(labels, k, X.dtype)
    active = torch.clamp(1.0 - Y * (X @ Wz + bz), min=0.0)
    g = (-2.0 / m) * (active * Y)
    owner = (torch.arange(m, device=X.device) // rows) % (blocks * warps) // warps
    gW = torch.zeros((p, k), dtype=torch.float64, device=X.device)
    gb = torch.zeros((k,), dtype=torch.float64, device=X.device)
    for blk in range(blocks):
        sel = owner == blk
        gW += (X[sel].T @ g[sel]).double()
        gb += torch.sum(g[sel], dim=0).double()
    new = fista_update_ref(W, b, Wz, bz, t, gW.to(X.dtype), gb.to(X.dtype), step, lam)
    for view, value in zip((W, b, Wz, bz, t, delta), new):
        view.copy_(value)
    iters += 1
