"""Sharding hints: the reference's ``with_sharding_constraint`` helpers,
no-ops when no mesh is active.

Counterpart of ``src/repro/models/hints.py``.  The JAX package pins the
batch axes at every block boundary and the head axes where the model axis
divides them, so that GSPMD keeps its intended plan.  Eager PyTorch has no
partitioner to hint: :func:`constrain` cleans its spec by the reference's
rules and returns its input unchanged, and :func:`clean_spec` exposes the
cleaned spec.  What the hints do carry in the port is the mesh itself:
:func:`axis_sizes` is how the rowwise MoE dispatch finds its row count.

The reference's ``with mesh:`` is :func:`use_mesh` here.  A mesh is anything
with axis names and sizes: a ``torch.distributed.device_mesh.DeviceMesh``
(``mesh_dim_names``, ``shape``) or an object with ``axis_names`` and
``shape[axis]`` (:class:`repro_torch.launch.mesh.AbstractMesh`, the dry
run's mesh without devices).

Under GSPMD one program sees every token of the batch; over
``torch.distributed`` each process holds only its rows.  A driver that
splits the batch's rows over several processes enters
:func:`use_token_shards` beside :func:`use_mesh`: the MoE then reads
:func:`token_shards` to plan a rank's tokens as its share of the reference's
global plan (one row of the rowwise dispatch; the global dispatch's
capacity, positions and aux loss over every rank's tokens).

A driver that cuts the weights over a ``model`` axis of ranks (tensor
parallelism, :mod:`repro_torch.runtime.tensor_parallel`) enters
:func:`use_model_shards` as well: the blocks then read
:func:`model_shards` to run on their heads, columns and experts and to
issue the model axis's sums.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import torch

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)
_SHARDS: contextvars.ContextVar = contextvars.ContextVar("repro_torch_token_shards",
                                                         default=None)
_MODEL: contextvars.ContextVar = contextvars.ContextVar("repro_torch_model_shards",
                                                        default=None)


class TokenShards(NamedTuple):
    """The batch's rows split over ``ranks`` processes, this one at
    ``index`` (rank ``i`` holds the ``i``-th contiguous block of rows, so of
    the tokens in batch-major order); ``group`` is their process group and
    ``comm`` the transport that counts each collective
    (:class:`repro_torch.runtime.data_parallel.Collectives`)."""
    group: Any
    ranks: int
    index: int
    comm: Any


@contextlib.contextmanager
def use_token_shards(shards: Optional[TokenShards]) -> Iterator[None]:
    """The token split the code inside runs under; ``None`` (one process
    holds every token) leaves none active."""
    token = _SHARDS.set(shards)
    try:
        yield
    finally:
        _SHARDS.reset(token)


def token_shards() -> Optional[TokenShards]:
    """The split entered by :func:`use_token_shards`, or None."""
    return _SHARDS.get()


class ModelShards(NamedTuple):
    """The weights cut over ``ranks`` processes of a ``model`` axis, this
    one at ``index``; ``group`` is their process group and ``comm`` the
    counting transport.  Every rank of the group holds the same rows."""
    group: Any
    ranks: int
    index: int
    comm: Any


@contextlib.contextmanager
def use_model_shards(shards: Optional[ModelShards]) -> Iterator[None]:
    """The model axis the code inside runs under; ``None`` (the whole
    weights in one process) leaves none active."""
    token = _MODEL.set(shards)
    try:
        yield
    finally:
        _MODEL.reset(token)


def model_shards() -> Optional[ModelShards]:
    """The model axis entered by :func:`use_model_shards`, or None."""
    return _MODEL.get()


def recompute_context(base=None):
    """``base`` (a context manager, or None) entered together with the mesh,
    token split and model axis active now: the context a checkpointed
    region's recompute runs under.  The backward of CUDA ops, and with it a
    remat recompute, runs on autograd's device thread, which does not see
    this thread's context (a recompute without the model axis would run a
    sub-block's local weights without its sums)."""
    mesh, shards, model = current_mesh(), token_shards(), model_shards()

    @contextlib.contextmanager
    def entered():
        with base or contextlib.nullcontext(), use_mesh(mesh), use_token_shards(shards), \
                use_model_shards(model):
            yield

    return entered()


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of anything with
    ``axis_names`` and ``shape[axis]``; ``{}`` for a mesh without axis
    names (a ``DeviceMesh`` built without ``mesh_dim_names``), which has no
    axis to pin."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # a DeviceMesh: shape is a tuple in dim order
        return {name: int(size) for name, size in zip(names, mesh.shape)}
    return {name: int(mesh.shape[name]) for name in getattr(mesh, "axis_names", ())}


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[None]:
    """The mesh the code inside runs under (the reference's ``with mesh:``);
    ``None`` leaves no mesh active."""
    token = _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(token)


def current_mesh():
    """The mesh entered by :func:`use_mesh`, or None."""
    return _MESH.get()


def axis_sizes() -> Dict[str, int]:
    m = current_mesh()
    return {} if m is None else mesh_axis_sizes(m)


def batch_axes() -> Tuple[str, ...]:
    sizes = axis_sizes()
    return tuple(a for a in ("pod", "data") if a in sizes)


def clean_spec(spec, sizes: Optional[Dict[str, int]] = None) -> Tuple:
    """``spec`` cleaned by the reference's rules against ``sizes`` (default:
    the active mesh's): axes the mesh lacks become None (a tuple keeps the
    axes it has, one axis left standing alone, as a ``PartitionSpec``
    holds it), and ``("model?", n)`` becomes ``"model"`` only where the
    model axis divides n."""
    sizes = axis_sizes() if sizes is None else sizes
    clean = []
    for s in spec:
        if s is None:
            clean.append(None)
        elif isinstance(s, tuple) and len(s) == 2 and s[0] == "model?":
            msz = sizes.get("model", 0)
            clean.append("model" if msz and s[1] % msz == 0 else None)
        elif isinstance(s, tuple):
            kept = tuple(a for a in s if a in sizes)
            clean.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        else:
            clean.append(s if s in sizes else None)
    return tuple(clean)


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """``x`` itself.  Under a mesh the spec is cleaned (:func:`clean_spec`)
    and checked against ``x``'s rank, as the reference's
    ``with_sharding_constraint`` would; without one nothing is done."""
    sizes = axis_sizes()
    if not sizes:
        return x
    if len(clean_spec(spec, sizes)) > x.dim():
        raise ValueError(f"sharding spec {spec} is longer than the rank {x.dim()}")
    return x


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """Pin the leading dim to the batch axes and the rest to None (a no-op
    here, as :func:`constrain`)."""
    ba = batch_axes()
    if not ba:
        return x
    return constrain(x, ba if len(ba) > 1 else ba[0], *([None] * (x.dim() - 1)))
