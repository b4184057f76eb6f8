"""Public wrappers around the hand-written kernels: padding and dispatch.

Counterpart of ``src/repro/kernels/ops.py``.  Each op pads its inputs to the
kernel's row block and dispatches on where its tensors lie:

* a CPU tensor goes to the plain PyTorch version in :mod:`.ref`;
* a CUDA tensor launches the CUDA kernel, or raises (a failed build or launch
  is an error, never a quiet switch to the plain version).

``use_kernel=False`` forces the plain version on a CUDA tensor; only the tests
and ``chip_smoke.py`` pass it, to compare the kernel with its plain version.

The ``*_batched`` ops take k classes on a leading axis (the class-batched
fit): one launch of the kernel for all of them on the card, and on the CPU
the plain version of each class in turn, so that every class gets the bits
of its own call on either device.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import flash_attention as _flash
from . import gram_update as _gram
from . import ihb_update as _ihb
from . import ref

# Row-block granularity of the canonical (streamable) Gram reduction: the
# degree step reduces in GRAM_BLOCK row blocks, so a chunked reduction is
# bit-identical to one call for any chunk that is a multiple of this.
GRAM_BLOCK = 256


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _kernel_path(t: torch.Tensor, use_kernel: Optional[bool]) -> bool:
    """True to launch the CUDA kernel, False for the plain version."""
    if t.device.type == "cuda":
        return use_kernel is not False
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}: expected cpu or cuda")
    if use_kernel:
        raise ValueError("use_kernel=True needs CUDA tensors")
    return False


def _pad_rows(T: torch.Tensor, m_pad: int) -> torch.Tensor:
    return T if T.shape[0] == m_pad else F.pad(T, (0, 0, 0, m_pad - T.shape[0]))


def gram_update(A, X, parents, vars_, *, bm: int = 512, use_kernel=None):
    """``(QL, C) = (A^T B, B^T B)`` with ``B = A[:, parents] * X[:, vars]``.

    Un-normalized (the caller divides by m).  The kernel path pads m to a
    multiple of ``bm``; the plain path is one un-blocked product, as in the
    JAX package's off-TPU fallback.
    """
    if not _kernel_path(A, use_kernel):
        return ref.gram_update_gather_ref(A, X, parents, vars_)
    m_pad = round_up(A.shape[0], bm)
    return _gram.gram_update(
        _pad_rows(A, m_pad), _pad_rows(X, m_pad), parents, vars_, bm=bm
    )


def gram_accumulate(A, X, parents, vars_, acc=None, *, bm: int = GRAM_BLOCK,
                    use_kernel=None):
    """Canonical blocked Gram reduction with carry: ``(acc_QL + A^T B,
    acc_C + B^T B)`` accumulated sequentially over ``bm``-row blocks.

    This is the degree step's Gram op.  ``acc=None`` starts from zeros.  ``m``
    is padded to a multiple of ``bm`` with zero rows (bitwise no-ops: the OAVI
    domain is >= +0.0).  Un-normalized; the caller divides by m.
    """
    L = A.shape[1]
    K = parents.shape[0]
    m_pad = round_up(A.shape[0], bm)
    A = _pad_rows(A, m_pad)
    X = _pad_rows(X, m_pad)
    if not _kernel_path(A, use_kernel):
        if acc is None:
            acc = (A.new_zeros((L, K)), A.new_zeros((K, K)))
        return ref.gram_accumulate_ref(A, X, parents, vars_, acc[0], acc[1], bm=bm)
    ql0, c0 = (None, None) if acc is None else acc
    return _gram.gram_update_acc(A, X, parents, vars_, ql0, c0, bm=bm)


def gram_accumulate_batched(A, X, parents, vars_, acc=None, *, bm: int = GRAM_BLOCK,
                            use_kernel=None):
    """:func:`gram_accumulate` for k classes: ``A (k, m, L)``, ``X (k, m,
    n)``, ``parents``/``vars (k, K)``, ``acc`` a ``((k, L, K), (k, K, K))``
    carry or None.  Returns ``QL (k, L, K)`` and ``C (k, K, K)``."""
    k, m, L = A.shape
    K = parents.shape[-1]
    m_pad = round_up(m, bm)
    if m_pad != m:
        A = F.pad(A, (0, 0, 0, m_pad - m))
        X = F.pad(X, (0, 0, 0, m_pad - m))
    if not _kernel_path(A, use_kernel):
        if acc is None:
            acc = (A.new_zeros((k, L, K)), A.new_zeros((k, K, K)))
        return ref.gram_accumulate_batched_ref(A, X, parents, vars_, acc[0], acc[1], bm=bm)
    ql0, c0 = (None, None) if acc is None else acc
    return _gram.gram_update_acc_batched(A, X, parents, vars_, ql0, c0, bm=bm)


def ihb_update_(N, q, btb, ell, *, active=None, use_kernel=None):
    """Theorem 4.9 padded block-inverse update of ``N`` in place (see
    :func:`.ref.ihb_update_ref`); returns ``N``.

    ``active`` (a bool tensor) makes the update conditional without a host
    sync: false leaves ``N`` as it is.  On the card ``btb`` (float32), ``ell``
    (int32) and ``active`` must be one-element tensors there.
    """
    if not _kernel_path(N, use_kernel):
        return N.copy_(ref.ihb_update_ref(N, q, btb, ell, active))
    return _ihb.ihb_update_(N, q, btb, ell, active)


def ihb_update(N, q, btb, ell, *, active=None, use_kernel=None):
    """The update of :func:`ihb_update_` on a copy of ``N``; ``N`` is
    unchanged.  For tests and comparisons: the fit updates in place."""
    return ihb_update_(N.clone(), q, btb, ell, active=active, use_kernel=use_kernel)


def ihb_update_batched_(N, q, btb, ell, *, active=None, use_kernel=None):
    """:func:`ihb_update_` for k classes, ``N (k, L, L)`` in place, ``q (k,
    L)``, ``btb``/``ell``/``active (k,)`` tensors on ``N``'s device; an
    inactive class's ``N`` is left as it is.  Returns ``N``."""
    if not _kernel_path(N, use_kernel):
        return N.copy_(ref.ihb_update_batched_ref(N, q, btb, ell, active))
    # the candidate loop hands over strided slices (a column of QL, C's
    # diagonal); the kernel reads each class's values at a fixed stride
    return _ihb.ihb_update_batched_(N, q.contiguous(), btb.contiguous(), ell.contiguous(),
                                    None if active is None else active.contiguous())


def ihb_degree_batched(QLt, C, N, ell0s, psi: float, Ks, *, use_kernel=None):
    """:func:`ihb_degree` for k classes (``QLt (k, Kcap, Lcap)``, ``C (k,
    Kcap, Kcap)``, ``N (k, Lcap, Lcap)`` in place, host ints ``ell0s[c]`` and
    ``Ks[c]``).  Returns ``(accepted, mses, coeffs, slots, ell)`` with a
    leading class axis; see :func:`.ref.ihb_degree_batched_ref`."""
    if not _kernel_path(N, use_kernel):
        return ref.ihb_degree_batched_ref(QLt, C, N, ell0s, psi, Ks)
    return _ihb.ihb_degree_batched(QLt, C, N, ell0s, psi, Ks)


def ihb_degree(QLt, C, N, ell0: int, psi: float, K: int, *, use_kernel=None):
    """The fast engine's candidate loop of one degree (``inverse_engine=
    'inverse'``), ``N`` updated in place: one launch of the hand-written
    kernel on the card, :func:`.ref.ihb_degree_ref` on the CPU.  Returns
    ``(accepted, mses, coeffs, slots, ell)`` as tensors on ``N``'s device."""
    if not _kernel_path(N, use_kernel):
        return ref.ihb_degree_ref(QLt, C, N, ell0, psi, K)
    return _ihb.ihb_degree(QLt, C, N, ell0, psi, K)


def multihead_attention(q, k, v, *, causal=True, use_kernel=None):
    """Attention over ``(B, Hq, Sq, d)`` queries and ``(B, Hkv, Sk, d|dv)``
    keys and values, GQA folded onto the flattened head axis; returns
    ``(B, Hq, Sq, dv)`` in q's type.

    Unlike the JAX package's op, nothing is padded and no shape goes to the
    plain version on the card: the kernel masks ragged edges itself.  Causal
    attention needs ``Sq == Sk`` on both paths.
    """
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv heads")
    group = Hq // Hkv
    qf = q.reshape(B * Hq, Sq, d)
    kf = k.reshape(B * Hkv, Sk, d)
    vf = v.reshape(B * Hkv, Sk, dv)
    if _kernel_path(q, use_kernel):
        out = _flash.flash_attention(qf, kf, vf, causal=causal, q_heads_per_kv=group)
    else:
        out = ref.attention_ref(qf, kf, vf, causal=causal, q_heads_per_kv=group)
    return out.reshape(B, Hq, Sq, dv)


def launch_counts() -> Dict[str, int]:
    """Launches of each CUDA kernel since the last reset, by Pallas kernel."""
    return {**_gram.launches, **_ihb.launches, **_flash.launches}


def reset_launch_counts() -> None:
    for counts in (_gram.launches, _ihb.launches, _flash.launches):
        for k in counts:
            counts[k] = 0
