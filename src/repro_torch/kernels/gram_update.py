"""Launcher of the hand-written CUDA Gram kernel (``csrc/gram_update.cu``).

The CUDA counterpart of the Pallas kernels ``gram_update_acc`` and
``gram_update`` (``src/repro/kernels/gram_update.py``): border evaluation
``B = A[:, parents] * X[:, vars]`` fused with both Gram products, reduced in
the canonical order (per ``bm``-row block partials folded left to right onto
the carry).  The plain PyTorch version is
:func:`repro_torch.kernels.ref.gram_accumulate_ref`; dispatch and padding live
in :mod:`repro_torch.kernels.ops`.

Two choices are made here, per call, from the shapes alone (so a chunked
call takes the same ones as the whole call, and no bit changes between them):

* the reduction: where the kernel's output tiles fill the card, one block per
  tile walks every row block and folds in registers (``path() == "fold"``);
  otherwise every row block's partial is computed in parallel into scratch
  and folded by a second pass (``"partials"``);
* the border columns: gathered inside the kernel from whole rows of A and X
  staged in shared memory (where they fit: small L and n), or materialised
  once per call into an ``m x K`` buffer and staged as plain columns.

:func:`gram_update_acc_batched` runs k problems of one shape (a leading class
axis on every array: the class-batched fit) in one launch of each kernel.
Both choices above, and the scratch grouping, are made from one problem's
shape, as a one-problem call would make them, so every lane gives the bits
of that call; the scratch is sized k times.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

# rows staged per shared-memory slab in the kernel: bm must be a multiple
SLAB_ROWS = 16
# largest partials buffer one call allocates; row blocks beyond it are walked
# in groups (each group a carried call, so the grouping changes no bit)
SCRATCH_BYTES = 256 << 20
_MAX_GRID_Y = 65535
# the in-block fold needs at least this many output tiles (None: one per SM)
FOLD_MIN_TILES: Optional[int] = None
# gather the border products inside the kernel where whole rows of A and X
# fit its staging ring (False: always materialise them first)
GATHER_BORDERS = True

# kernel launches made through these wrappers, by Pallas kernel name (the
# class-batched entry counts one launch for all its classes)
launches = {"gram_update_acc": 0, "gram_update": 0, "gram_update_acc_batched": 0}


def path(L: int, K: int, device: torch.device) -> str:
    """``"fold"`` or ``"partials"``: the reduction a call of these widths takes."""
    tiles = _build.library().repro_gram_tiles(L, K)
    need = FOLD_MIN_TILES
    if need is None:
        need = torch.cuda.get_device_properties(device).multi_processor_count
    return "fold" if tiles >= need else "partials"


def borders(L: int, n: int) -> str:
    """``"gathered"`` or ``"materialised"``: where a call with these widths
    takes its border columns from."""
    gather = GATHER_BORDERS and bool(_build.library().repro_gram_can_gather(L, n))
    return "gathered" if gather else "materialised"


def _check_f32(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(A, X, parents, vars_, acc: Optional[Tuple], bm: int, name: str):
    """One launch for a 2-D problem, or for k of them stacked on a leading
    class axis (3-D ``A`` and ``X``, 2-D ``parents`` and ``vars``)."""
    device = A.device
    if device.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got {device}")
    batched = name.endswith("_batched")
    if A.dim() != X.dim() or A.dim() != (3 if batched else 2):
        raise ValueError(f"{name}: A and X must be {3 if batched else 2}-D")
    lane = tuple(A.shape[:1]) if batched else ()
    lanes = A.shape[0] if batched else 1
    m, L = A.shape[-2:]
    n = X.shape[-1]
    K = parents.shape[-1]
    _check_f32("A", A, lane + (m, L), device)
    _check_f32("X", X, lane + (m, n), device)
    if parents.shape != lane + (K,) or vars_.shape != lane + (K,):
        raise ValueError(f"parents and vars must be of shape {lane + (K,)}")
    if not 1 <= lanes <= _MAX_GRID_Y:
        raise ValueError(f"{lanes} classes: one launch takes 1 to {_MAX_GRID_Y}")
    if bm <= 0 or bm % SLAB_ROWS or m % bm:
        raise ValueError(
            f"m={m} must be a multiple of bm={bm}, itself a multiple of {SLAB_ROWS}"
        )
    if acc is not None:
        _check_f32("ql0", acc[0], lane + (L, K), device)
        _check_f32("c0", acc[1], lane + (K, K), device)
    QL = torch.empty(lane + (L, K), dtype=torch.float32, device=device)
    C = torch.empty(lane + (K, K), dtype=torch.float32, device=device)
    if K == 0:
        return QL, C
    p32 = parents.to(device=device, dtype=torch.int32).contiguous()
    v32 = vars_.to(device=device, dtype=torch.int32).contiguous()
    nb = m // bm
    fold = path(L, K, device) == "fold"
    if fold:
        group, scratch = nb, None
    else:
        per_block = _build.library().repro_gram_partial_floats(L, K)
        # one problem's grouping (a one-problem call's), the scratch k times
        group = max(1, min(nb, _MAX_GRID_Y, SCRATCH_BYTES // (4 * per_block)))
        scratch = torch.empty(lanes * group * per_block, dtype=torch.float32, device=device)
    border = None
    if borders(L, n) == "materialised" and m > 0:
        border = torch.empty(lane + (m, K), dtype=torch.float32, device=device)
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.repro_gram_update(
            A.data_ptr(), X.data_ptr(), p32.data_ptr(), v32.data_ptr(),
            acc[0].data_ptr() if acc is not None else None,
            acc[1].data_ptr() if acc is not None else None,
            QL.data_ptr(), C.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            border.data_ptr() if border is not None else None,
            m, L, n, K, bm, group, int(fold), lanes, stream,
        )
    _build.check(err, name)
    launches[name] += 1
    return QL, C


def gram_update_acc(A, X, parents, vars_, ql0=None, c0=None, *, bm: int):
    """``(ql0 + A^T B, c0 + B^T B)`` on the card, ``m`` a multiple of ``bm``;
    no carry (``ql0 = c0 = None``) starts from zeros."""
    acc = None if ql0 is None and c0 is None else (ql0, c0)
    return _launch(A, X, parents, vars_, acc, bm, "gram_update_acc")


def gram_update_acc_batched(A, X, parents, vars_, ql0=None, c0=None, *, bm: int):
    """:func:`gram_update_acc` for k classes in one launch: ``A (k, m, L)``,
    ``X (k, m, n)``, ``parents``/``vars (k, K)``, the carry ``(k, L, K)``,
    ``(k, K, K)`` or None; returns ``QL (k, L, K)`` and ``C (k, K, K)``, each
    lane the bits of :func:`gram_update_acc` on that lane alone."""
    acc = None if ql0 is None and c0 is None else (ql0, c0)
    return _launch(A, X, parents, vars_, acc, bm, "gram_update_acc_batched")


def gram_update(A, X, parents, vars_, *, bm: int = 512):
    """``(A^T B, B^T B)`` on the card: the zero-carry form of the same kernel."""
    return _launch(A, X, parents, vars_, None, bm, "gram_update")
