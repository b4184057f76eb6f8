"""Data-parallel OAVI over ``torch.distributed``: the paper's technique on
many cards.

Counterpart of ``src/repro/core/distributed.py``.  The degree-batched Gram
formulation of :mod:`repro_torch.core.oavi` is the unit of distribution.
With the sample axis ``m`` split over the data axes of a
``torch.distributed.device_mesh.DeviceMesh``:

* step (1), the candidate columns ``B = A[:, parents] * X[:, vars]``, is
  local to each rank's rows;
* step (2), the two Gram products, runs through
  :func:`repro_torch.kernels.ops.gram_accumulate` (the hand-written kernel
  on the card) on each rank's rows, followed by ONE ``all_reduce(SUM)`` of
  the raw ``(QL, C)`` over the group that spans the data axes: the only
  collective, ``L*K + K*K`` floats a degree whatever ``m`` is;
* step (3), the sequential candidate loop
  (:func:`repro_torch.core.oavi.stats_step`), runs on the reduced blocks,
  replicated on every rank; appended columns go into the rank's own A.

SPMD, as ``torch.distributed`` runs: one process per rank, every rank calls
:func:`fit` with the same ``X`` and returns the same model.  Each rank keeps
only its contiguous row span.  Where the reference pads ``m`` to a multiple
of the shard count, the port pads it to a multiple of ``shards *
GRAM_BLOCK`` (256), so that every span is a whole number of Gram blocks and
starts on a block boundary: the streamed sharded fit
(:func:`repro_torch.streaming.fit` with ``mesh=``) then folds each span's
chunks onto the carry with the same block partition and equals this fit bit
for bit (``stats["m_padded"]`` differs from the reference's).  Padded rows
are exact zeros, the constant column too (it is the row mask), and add
nothing to any Gram entry.

Bits: a world of one (a mesh of one rank, or no process group at all, which
issues no collective) is the local fit bit for bit, as a one-rank
all_reduce is a copy.  At a world of several ranks the all_reduce sums the
shards' partials in its own order, not the single device's block order: the
fits agree with the local fit in structure, and in coefficients to fp32
reduction-order noise.  Every rank gets the all_reduce's one result, so
every rank's model is the same bit for bit.

The collective backend follows the tensors: NCCL for CUDA tensors, gloo for
CPU ones (two ranks on one card need gloo, which stages CUDA tensors
through the host; NCCL refuses two ranks on one device).  The caller
initialises the process group and builds the mesh (``init_device_mesh``);
nothing here creates a process group.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import _device, obs
from ..kernels import ops as kernel_ops
from .oavi import (
    FitScope,
    OAVIConfig,
    OAVIModel,
    check_config,
    fit_rows,
    init_fit_stats,
    order_features,
)


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Where this rank sits among the data shards: the process group that
    spans the data axes (``None``: a world of one without a collective),
    the shard count and this rank's shard index (row-major over the data
    axes, the reference's ``PartitionSpec`` order)."""

    group: Optional[object]
    shards: int
    index: int
    mesh: Dict[str, int]
    data_axes: Tuple[str, ...]

    def rows(self, m: int) -> Tuple[int, int, int]:
        """``(lo, span, m_padded)``: this rank holds rows ``[lo, lo + span)``
        of ``m`` padded to ``m_padded = round_up(m, shards * GRAM_BLOCK)``."""
        m_padded = kernel_ops.round_up(max(int(m), 1), self.shards * kernel_ops.GRAM_BLOCK)
        span = m_padded // self.shards
        return self.index * span, span, m_padded

    def span(self, m: int) -> Tuple[int, int]:
        """The real rows ``[lo, hi)`` of ``m`` that this rank holds (empty
        where its span lies wholly in the padding)."""
        lo, span, _ = self.rows(m)
        return lo, max(lo, min(lo + span, m))

    def reducer(self, stats: Dict):
        """``(QL, C) -> (sum over shards of QL, ... of C)``: ONE all_reduce of
        both blocks, counted in ``stats["all_reduces"]`` and its host seconds
        (the wait for the other ranks included) in
        ``stats["all_reduce_seconds"]``.  A world of one without a group
        returns the blocks as they are."""

        def reduce(*blocks):
            if self.group is None:
                return blocks
            flat = torch.cat([b.reshape(-1) for b in blocks])
            t0 = time.perf_counter()
            with obs.span("fit/all_reduce", numel=int(flat.numel()), shards=self.shards):
                dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
            stats["all_reduce_seconds"] += time.perf_counter() - t0
            stats["all_reduces"] += 1
            obs.event("fit/shard_step", shard=self.index)
            out, at = [], 0
            for b in blocks:
                out.append(flat[at: at + b.numel()].view(b.shape))
                at += b.numel()
            return tuple(out)

        return reduce

    def stats(self, m: int) -> Dict:
        """The sharded fit's own stats keys."""
        return {"mesh": dict(self.mesh), "data_axes": list(self.data_axes),
                "m_padded": self.rows(m)[2], "all_reduces": 0, "all_reduce_seconds": 0.0}


def layout(mesh=None, data_axes: Sequence[str] = ("data",)) -> ShardLayout:
    """This rank's :class:`ShardLayout` on ``mesh`` (a ``DeviceMesh`` whose
    ``mesh_dim_names`` include ``data_axes``); ``mesh=None`` is a world of
    one with no collective."""
    axes = tuple(data_axes)
    if mesh is None:
        return ShardLayout(group=None, shards=1, index=0, mesh={}, data_axes=axes)
    names = tuple(mesh.mesh_dim_names or ())
    missing = [a for a in axes if a not in names]
    if not axes or missing:
        raise ValueError(f"data_axes {axes!r} are not dims of the mesh {names!r}")
    sizes = dict(zip(names, (int(s) for s in mesh.shape)))
    coord = dict(zip(names, mesh.get_coordinate()))
    index = 0
    for a in axes:
        index = index * sizes[a] + int(coord[a])
    group = mesh.get_group(axes[0]) if len(axes) == 1 else mesh[axes]._flatten().get_group()
    return ShardLayout(group=group, shards=int(np.prod([sizes[a] for a in axes])),
                       index=index, mesh=sizes, data_axes=axes)


def fit(
    X,
    config: OAVIConfig = OAVIConfig(),
    *,
    mesh=None,
    data_axes: Sequence[str] = ("data",),
    device=None,
) -> OAVIModel:
    """Data-parallel OAVI: the semantics of :func:`repro_torch.core.oavi.fit`,
    the sample axis split over ``data_axes`` of ``mesh``.  Every rank calls
    it with the same ``X`` and gets the same model.  ``device=None`` means
    the CUDA card (the rank's current device)."""
    check_config(config)
    dev = _device.resolve(device)
    lay = layout(mesh, data_axes)
    X = np.asarray(X)
    m, n = X.shape
    stats = init_fit_stats(m, n, device=dev, **lay.stats(m))
    with FitScope(stats, backend="sharded", device=dev) as scope:
        X, perm = order_features(X, config.ordering)
        lo, hi = lay.span(m)
        Xd = torch.zeros((lay.rows(m)[1], n), dtype=config.torch_dtype(), device=dev)
        Xd[: hi - lo] = _device.tensor(X[lo:hi], config.torch_dtype(), dev)
        book, generators, Lcap = fit_rows(Xd, hi - lo, m, config, scope,
                                          reduce=lay.reducer(stats))
        scope.finalize(book, generators, Lcap, config)
    return OAVIModel(n=n, psi=config.psi, book=book, generators=generators, feature_perm=perm,
                     stats=stats, dtype=config.dtype, device=dev)
