"""Data-parallel, sharded and tensor-parallel LM training and serving over
``torch.distributed``.

Counterpart of the reference's GSPMD placement in ``src/repro/launch/train.py``
(``make_sharded_train_state``: parameters and moments put into the
``param_specs`` / ``AdamW.state_specs`` shardings) on meshes of ``pod``,
``data`` and ``model`` axes.  One process a rank, each holding the same
model code; the batch's rows are split over the batch axes (``pod`` x
``data``, row-major, the group of
:func:`repro_torch.core.distributed.layout`), and every rank of a model
group (the ranks that share a data index) holds the same rows.

:class:`DataParallelPlan` is the per-leaf plan.  A parameter whose spec
(after ``fit_spec``'s divisibility rule) cuts a dimension over ``data``, and
whose moments' spec cuts the same one, is *sharded*: between steps a rank
keeps only its contiguous block of that dimension, of the parameter and of
both fp32 moments.  Every other leaf is *replicated* over ``data`` (the int8
moments' blocks cut across the parameter's shape, so with them every leaf
is).  A ``pod`` axis replicates every parameter: the reference's specs name
only ``data`` and ``model``.  A leaf whose spec names ``model`` is cut over
a model axis larger than 1 as well (:mod:`.tensor_parallel`): a rank holds
its block over both axes, and computes on its model block (a packed
matrix's block is ``[p0_r | p1_r | ...]``, an mLSTM head projection's the
rank's heads), or on the whole leaf for attention KV leaves the KV heads do
not divide and a frames frontend's ``embed_proj``.  8-bit moments stay
replicated over ``model`` too, as the reference's ``state_specs`` keeps
them: every rank holds the one-device layout's int8 blocks of every leaf,
and updates them from the whole gradient.  A step
(:func:`repro_torch.launch.train.make_step`) runs

* :meth:`loss_and_grads`, the loss and the rank's synchronised gradients:
  - :meth:`gather_params` of the leaves outside the periods (the
    embedding, an untied head, ``embed_proj``): one
    ``all_gather_into_tensor`` a leaf cut over data, into the model's
    tensor of its model block (a shard dimension other than 0 goes through
    a contiguous staging tensor), and one over the model group for a
    gathered leaf;
  - on a data axis larger than 1, each period's leaves the step gathers
    (``per_period``) gathered inside that period, just before its blocks
    run, by the same :meth:`compute`, and freed when its forward returns;
    a remat recompute gathers them again (the non-reentrant checkpoint
    saves only the rank's blocks, :class:`_PeriodLeaf`); with remat off
    autograd keeps every period's gathered weights for the backward, as
    the reference's scan without ``jax.checkpoint`` keeps its residuals.
    Each of their gradients is synchronised by :meth:`sync_grad` as that
    period's backward ends, and the full gradient freed, as the
    reference's scanned GSPMD step reduce-scatters a period's gradient as
    the reverse scan leaves it.  On a data axis of 1 (a model axis alone)
    every gathered leaf is gathered for the step;
  - the loss and ``torch.autograd.grad`` on the rank's rows, the blocks
    issuing the model axis's sums (:mod:`.tensor_parallel`);
  - :meth:`sync_grads` of the other leaves, :meth:`sync_grad` a leaf: over
    the model group, ``reduce_scatter_tensor(SUM)`` of a gathered KV leaf
    (``embed_proj``'s gradient is whole: the rank keeps its block) and
    ``all_reduce(SUM)`` of a leaf each model rank holds in part
    (``tensor_parallel.partial_leaf``); then ``reduce_scatter_tensor(SUM)``
    over data (then ``all_reduce(SUM)`` over pod) for a sharded leaf,
    ``all_reduce(SUM)`` over the batch group for a replicated one, each
    divided by the batch world (SUM and a division: ``ReduceOp.AVG`` is
    not every backend's);
* :meth:`release_params`: the gathered tensors freed (the update needs
  only the blocks);
* :meth:`sq_norm`: the global sum of squared gradients for ``clip_norm``,
  every block once, in one ``all_reduce`` over the mesh;
* with 8-bit moments on a model axis, :meth:`moment_grads`: each model
  block's gradient gathered over ``model`` into the one-device layout;
* ``AdamW.update`` (the moments of the whole leaf, the update cut to the
  rank's block by :meth:`cut`).

The per-period schedule issues the whole-step schedule's collectives on
the same tensors, at other times, so the step's bits are the same; it
holds at once the full tensors of the leaves outside the periods and of
one period (its weights and their gradients), where the whole-step
schedule holds the whole model's twice.  :attr:`DataParallelPlan.held`
counts the bytes of the full tensors a step holds (gathered weights and
full gradients of the leaves it gathers) and ``held_peak`` their most at
once (:meth:`reset_held`); :meth:`held_bound` is what the schedule may
hold at most.

A world of one issues no collective and keeps the one-device step's bits:
every leaf is replicated, the parameters are the model's own tensors, and
:meth:`sq_norm` sums the squares as ``AdamW.update`` does.

:class:`Collectives` is the transport: each collective of the plan, of the
model axis and of the MoE across ranks (:mod:`repro_torch.models.moe`: the
aux loss's two ``all_reduce`` and the global dispatch's ``all_gather`` of
expert counts) goes through it and is counted by kind in result bytes, as
``launch/hlo_analysis.py``'s ``collective_bytes`` counts an HLO module's;
:meth:`DataParallelPlan.collective_bytes` predicts those counts from shapes
(the dry run's LM cells take them from here).  Gloo takes CUDA tensors for
all three collectives, so two ranks share one card under gloo (NCCL refuses
two ranks on one device); nothing is staged here.
"""

from __future__ import annotations

import contextlib
import math
import time
import weakref
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from .. import _device
from ..core import distributed
from ..models import hints, moe
from ..models import model as M
from . import tensor_parallel as tp

KINDS = ("all-reduce", "all-gather", "reduce-scatter")


class _TwoWaySum(torch.autograd.Function):
    """``all_reduce(SUM)`` forward and ``all_reduce(SUM)`` of the gradient
    backward (``torch.distributed.nn.functional.all_reduce``), both through
    a :class:`Collectives`, so both are counted.  Right for a sum every rank
    goes on to use as its own (the MoE aux loss's global mean over the batch
    ranks); not the model axis's ``g``, whose backward is the identity
    (:mod:`.tensor_parallel`)."""

    @staticmethod
    def forward(ctx, comm, group, t):
        ctx.comm, ctx.group = comm, group
        out = t.clone(memory_format=torch.contiguous_format)
        comm.all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return None, None, _TwoWaySum.apply(ctx.comm, ctx.group, grad)


class _PeriodLeaf(torch.autograd.Function):
    """A per-period leaf's compute tensor from this rank's block: forward
    :meth:`DataParallelPlan.compute` (its gathers), backward the full
    gradient synchronised into the block's (:meth:`DataParallelPlan.
    sync_grad`).  It saves nothing, so a checkpointed period keeps only the
    block and its recompute gathers again."""

    @staticmethod
    def forward(ctx, plan, name, part):
        ctx.plan, ctx.name = plan, name
        return plan._held(plan.compute(name, part))

    @staticmethod
    def backward(ctx, grad):
        return None, None, ctx.plan._period_grad(ctx.name, grad)


class _PeriodInput(torch.autograd.Function):
    """The identity on a period's input.  Its backward runs as the period's
    backward ends, which is where the period before it starts its own: that
    period's full gradients are counted held from then on."""

    @staticmethod
    def forward(ctx, plan, period, x):
        ctx.plan, ctx.period = plan, period
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if ctx.period > 0:
            ctx.plan._pend(k for k, _, _ in ctx.plan.periods[ctx.period - 1])
        return None, None, grad


class Collectives:
    """``torch.distributed``'s collectives as the plan and the MoE issue
    them, each counted: ``bytes[kind]`` sums the result bytes this rank
    receives (an ``all_reduce``'s tensor, an ``all_gather``'s gathered
    tensor, a ``reduce_scatter``'s shard) and ``seconds`` their host time (a
    call returns when its result is ready)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.bytes = dict.fromkeys(KINDS, 0)
        self.seconds = 0.0

    def _issue(self, kind: str, result: torch.Tensor, fn) -> None:
        t0 = time.perf_counter()
        fn()
        self.seconds += time.perf_counter() - t0
        self.bytes[kind] += result.numel() * result.element_size()

    def all_reduce(self, t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced over ``group`` (a sum unless ``op`` says otherwise),
        in place."""
        self._issue("all-reduce", t, lambda: dist.all_reduce(t, op=op, group=group))
        return t

    def all_reduce_grad(self, t: torch.Tensor, group) -> torch.Tensor:
        """``t`` summed over ``group`` (a new tensor); the gradient flows
        back through the same sum (:class:`_TwoWaySum`)."""
        return _TwoWaySum.apply(self, group, t)

    def all_gather(self, out: torch.Tensor, t: torch.Tensor, group) -> torch.Tensor:
        """Every rank's ``t`` laid end to end along dim 0 in ``out``."""
        self._issue("all-gather", out,
                    lambda: dist.all_gather_into_tensor(out, t, group=group))
        return out

    def reduce_scatter(self, out: torch.Tensor, t: torch.Tensor, group) -> torch.Tensor:
        """This rank's block (dim 0) of ``t`` summed over ``group``."""
        self._issue("reduce-scatter", out, lambda: dist.reduce_scatter_tensor(
            out, t, op=dist.ReduceOp.SUM, group=group))
        return out


def check_mesh(mesh, cfg=None) -> Dict[str, int]:
    """The mesh's ``{axis: size}`` when this plan can run on it: its ranks
    lie on the ``pod``, ``data`` and ``model`` axes (a mesh of several ranks
    without them, or a ``DeviceMesh`` without axis names, raises
    ``ValueError``), and with ``cfg`` given, the config runs on its model
    axis (:func:`.tensor_parallel.check_config`)."""
    sizes = hints.mesh_axis_sizes(mesh)
    known = math.prod(sizes.get(a, 1) for a in ("pod", "data", "model"))
    if known != mesh.size():
        raise ValueError(f"a mesh of {mesh.size()} devices with axes {sizes or 'unnamed'}: "
                         "its ranks must lie on the pod, data and model axes")
    if cfg is not None:
        tp.check_config(cfg, sizes.get("model", 1))
    return sizes


def mesh_device(mesh, device=None, cfg=None) -> torch.device:
    """The device this rank runs on: ``device`` without a mesh (``None``:
    the CUDA card), else the mesh's device type, on the card the rank's
    current device.  The mesh must pass :func:`check_mesh` (for ``cfg``),
    and a mesh of several ranks needs ``torch.distributed`` initialised (one
    process a rank)."""
    if mesh is None:
        return _device.resolve(device)
    check_mesh(mesh, cfg)
    if mesh.size() > 1 and not dist.is_initialized():
        raise RuntimeError(f"a mesh of {mesh.size()} ranks runs one process a rank: "
                           "initialise torch.distributed in each first")
    dev = _device.resolve(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Leaf(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype
    dim: Optional[int]  # the dimension cut over ``data``; None: replicated
    mdim: Optional[int] = None  # the dimension cut over ``model``; None: replicated
    gathered: bool = False  # whole for compute: gathered over model, gradient cut back
    partial: bool = False  # its gradient a partial sum over model: summed (or scattered)
    packed: int = 0  # the parts of a packed matrix: model blocks of [p0_r | p1_r | ...]


def _axes(entry) -> Tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


def _data_dim(spec) -> Optional[int]:
    for dim, entry in enumerate(spec):
        if "data" in _axes(entry):
            return dim
    return None


def _model_dim(spec) -> Optional[int]:
    for dim, entry in enumerate(spec):
        if "model" in _axes(entry):
            return dim
    return None


def _leaf(cfg, name, p, spec, data_dim, k) -> Leaf:
    if k == 1:
        return Leaf(tuple(p.shape), p.dtype, data_dim)
    mdim = 0 if tp.head_leaf(name, p.shape) else _model_dim(spec)
    kv = tp.uneven_kv_leaf(cfg, name, p.shape, k)
    return Leaf(tuple(p.shape), p.dtype, data_dim, mdim,
                gathered=mdim is not None and (kv or tp.frames_leaf(name)),
                partial=kv or tp.partial_leaf(name),
                packed=0 if mdim is None else tp.packed_parts(name, p.shape))


def _cut(t: torch.Tensor, dim: int, ways: int, index: int) -> torch.Tensor:
    n = t.shape[dim] // ways
    return t.narrow(dim, index * n, n)


class DataParallelPlan:
    """The per-leaf plan of ``cfg``'s parameters (a model or a dict of
    name -> tensor, on any device, ``meta`` included) on ``mesh``: sharded
    over ``data`` or replicated, as ``param_specs`` and ``opt.state_specs``
    cut them, and cut over ``model`` where the spec names it.  ``opt=None``
    plans serving: every leaf replicated over ``data``, as the reference's
    serve leaves its parameters, and cut over ``model``.  ``mesh=None`` is
    a world of one.  On a ``DeviceMesh`` the plan runs (its groups are the
    mesh's; a config the model axis cannot cut raises); on an
    :class:`~repro_torch.launch.mesh.AbstractMesh` it only counts
    (``refusal`` then says why a config cannot run on its model axis, where
    its heads or channels do not split: the counts are the plan's as if
    they did)."""

    def __init__(self, cfg, params_like, mesh=None, opt=None):
        runs = mesh is not None and hasattr(mesh, "get_group")
        sizes = {} if mesh is None else (check_mesh(mesh, cfg) if runs
                                         else hints.mesh_axis_sizes(mesh))
        self.cfg, self.mesh, self.opt = cfg, mesh, opt
        self.shards = sizes.get("data", 1)  # ways a sharded leaf is cut
        self.pods = sizes.get("pod", 1)
        self.world = self.shards * self.pods  # ranks holding separate rows
        self.model = sizes.get("model", 1)  # ranks sharing rows, each a block of the weights
        self.ranks = self.world * self.model
        self.refusal = None
        try:
            tp.check_config(cfg, self.model)
        except ValueError as e:
            self.refusal = str(e)
        # 8-bit moments of whole leaves, every rank's the one-device layout's
        self.whole_moments = self.model > 1 and opt is not None and opt.quantize_states
        self.vocab_cut = self.model > 1 and cfg.vocab_size % self.model == 0
        params = dict(params_like.named_parameters()) if isinstance(
            params_like, torch.nn.Module) else dict(params_like)
        pspecs = M.param_specs(cfg, params, mesh) if sizes else dict.fromkeys(params, ())
        dims = dict.fromkeys(params)
        if self.shards > 1 and opt is not None:
            mu_specs = opt.state_specs(pspecs).mu
            dims = {k: _data_dim(s) if mu_specs[k] == s else None for k, s in pspecs.items()}
        self.leaves = {k: _leaf(cfg, k, p, pspecs[k], dims[k], self.model)
                       for k, p in params.items()}
        # each period's gathered leaves, (name, block index, name in the block),
        # gathered inside the period where a period's leaf is cut over data
        stepped = self._stepped()
        self.periods = [[] for _ in range(cfg.n_periods)]
        for k in stepped:
            if k.startswith("blocks."):
                _, j, local = k.split(".", 2)
                self.periods[int(j) // len(cfg.period)].append((k, int(j), local))
        cut = any(self.leaves[k].dim is not None for part in self.periods for k, _, _ in part)
        self.per_period = {k for part in self.periods for k, _, _ in part} if cut else set()
        self.held = self.held_peak = 0
        self._parts: Dict[str, torch.Tensor] = {}
        self._pending: Dict[str, int] = {}  # full gradients counted before they are seen
        self._settled = set()
        self.comm = Collectives()
        self.index = self.shard_index = self.pod_index = self.model_index = 0
        self.batch_group = self.shard_group = self.pod_group = None
        self.model_group = self.mesh_group = None
        if runs and self.world > 1:
            batch = distributed.layout(mesh, M.batch_axes(mesh))
            data = distributed.layout(mesh, ("data",))
            self.batch_group, self.index = batch.group, batch.index
            self.shard_group, self.shard_index = data.group, data.index
            if self.pods > 1:
                pod = distributed.layout(mesh, ("pod",))
                self.pod_group, self.pod_index = pod.group, pod.index
        self.mesh_group = self.batch_group
        if runs and self.model > 1:
            lay = distributed.layout(mesh, ("model",))
            self.model_group, self.model_index = lay.group, lay.index
            self.mesh_group = (self.model_group if self.world == 1 else
                               distributed.layout(mesh, tuple(mesh.mesh_dim_names)).group)

    # -- the batch's rows -----------------------------------------------------

    def rows(self, global_batch: int) -> Tuple[int, int]:
        """``(first row, row count)`` of this rank's block of the batch;
        a batch the ranks do not divide raises, as the reference's
        ``device_put`` does."""
        if global_batch % self.world:
            raise ValueError(f"a batch of {global_batch} rows does not split over "
                             f"{self.world} ranks")
        n = global_batch // self.world
        return self.index * n, n

    @contextlib.contextmanager
    def scope(self) -> Iterator[None]:
        """The mesh, the token split and the model axis (none for a world
        of one) a step runs under: the reference's ``with mesh:``."""
        shards = (None if self.world == 1 else
                  hints.TokenShards(self.batch_group, self.world, self.index, self.comm))
        model = (None if self.model == 1 else
                 hints.ModelShards(self.model_group, self.model, self.model_index, self.comm))
        with hints.use_mesh(self.mesh), hints.use_token_shards(shards), \
                hints.use_model_shards(model):
            yield

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``t`` (dim 0) in rank order."""
        if self.world == 1:
            return t
        out = t.new_empty((t.shape[0] * self.world, *t.shape[1:]))
        return self.comm.all_gather(out, t.contiguous(), self.batch_group)

    def gather_vocab(self, t: torch.Tensor) -> torch.Tensor:
        """Vocabulary-parallel logits (last dim this rank's block) gathered
        over the model axis into the whole vocabulary; logits of a
        vocabulary the axis does not cut are whole already."""
        if not self.vocab_cut:
            return t
        return self._gather_dim(t, t.dim() - 1, self.model, self.model_group)

    # -- parameters -----------------------------------------------------------

    def sharded(self):
        """The leaves cut over ``data``."""
        return [k for k, leaf in self.leaves.items() if leaf.dim is not None]

    def _stepped(self):
        """The leaves whose compute tensor is gathered for a step and freed
        after it: those cut over data, and the gathered ones."""
        return [k for k, leaf in self.leaves.items() if leaf.dim is not None or leaf.gathered]

    def _whole(self, name: str) -> bool:
        """The leaf is replicated over every axis: a rank holds all of it."""
        leaf = self.leaves[name]
        return leaf.dim is None and leaf.mdim is None

    def cut(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of a leaf (its own storage) or, replicated over
        every axis, the leaf itself."""
        leaf = self.leaves[name]
        if self._whole(name):
            return full
        if leaf.packed:
            full = tp.pack_columns(full, self.model, leaf.packed)
        if leaf.mdim is not None:
            full = _cut(full, leaf.mdim, self.model, self.model_index)
        if leaf.dim is not None:
            full = _cut(full, leaf.dim, self.shards, self.shard_index)
        return full.clone(memory_format=torch.contiguous_format)

    @torch.no_grad()
    def _gather_dim(self, part: torch.Tensor, dim: int, ways: int, group) -> torch.Tensor:
        if ways == 1:
            return part
        src = part.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] * ways, *src.shape[1:]))
        self.comm.all_gather(out, src, group)
        return out if dim == 0 else out.movedim(0, dim).contiguous()

    def compute(self, name: str, part: torch.Tensor) -> torch.Tensor:
        """The tensor the model computes with from this rank's block: the
        model block (gathered over data), or for a gathered leaf the whole
        leaf."""
        leaf = self.leaves[name]
        if leaf.dim is not None:
            part = self._gather_dim(part, leaf.dim, self.shards, self.shard_group)
        if leaf.gathered:
            part = self._gather_dim(part, leaf.mdim, self.model, self.model_group)
        return part

    def gather(self, name: str, part: torch.Tensor) -> torch.Tensor:
        """The whole leaf in the one-device layout from every rank's block."""
        leaf = self.leaves[name]
        if leaf.dim is not None:
            part = self._gather_dim(part, leaf.dim, self.shards, self.shard_group)
        if leaf.mdim is not None:
            part = self._gather_dim(part, leaf.mdim, self.model, self.model_group)
        return tp.unpack_columns(part, self.model, leaf.packed) if leaf.packed else part

    def shard_params(self, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
        """The rank's parameters at rest: the model's own tensor of a leaf
        it computes on as held (replicated, or its model block, which then
        becomes the model's tensor), its block of a sharded or gathered one;
        the model's full tensors of those are freed (:meth:`release_params`)."""
        stepped = set(self._stepped())
        out = {}
        for k, p in model.named_parameters():
            if k in stepped:
                out[k] = self.cut(k, p.detach())
            else:
                if not self._whole(k):
                    p.data = self.cut(k, p.detach())
                out[k] = p
        self.release_params(model)
        return out

    def adopt(self, model: torch.nn.Module, params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """:meth:`shard_params` for a restored tree of this rank's leaves:
        the leaves the model computes on as held are copied into the model,
        blocks kept."""
        live = dict(model.named_parameters())
        stepped = set(self._stepped())
        out = {}
        with torch.no_grad():
            for k, p in live.items():
                src = torch.as_tensor(params[k])
                if k not in stepped:
                    out[k] = p.copy_(src.to(dtype=p.dtype))
                else:
                    out[k] = src.to(device=p.device, dtype=p.dtype).contiguous()
        return out

    @torch.no_grad()
    def gather_params(self, model: torch.nn.Module, params: Dict[str, torch.Tensor],
                      names=None) -> None:
        """Give the model its compute tensors of ``names`` (default: every
        sharded and gathered leaf)."""
        live = dict(model.named_parameters())
        for k in self._stepped() if names is None else names:
            live[k].data = self._held(self.compute(k, params[k]))

    def release_params(self, model: torch.nn.Module) -> None:
        """Free the model's compute tensors of the sharded and gathered
        leaves."""
        live = dict(model.named_parameters())
        for k in self._stepped():
            live[k].data = live[k].data.new_empty(0)

    # -- held bytes -------------------------------------------------------------

    def _count(self, nbytes: int) -> None:
        self.held += nbytes
        self.held_peak = max(self.held_peak, self.held)

    def _held(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, a full tensor of a step, counted in :attr:`held` until its
        storage is freed."""
        storage = t.untyped_storage()
        if t.untyped_storage() is not storage:
            raise RuntimeError("counting held bytes needs a torch whose storages keep "
                               "their Python object")
        nbytes = t.numel() * t.element_size()
        self._count(nbytes)
        weakref.finalize(storage, self._count, -nbytes)
        return t

    def reset_held(self) -> None:
        """Start ``held_peak`` again from what is held now."""
        self.held_peak = self.held

    def _compute_bytes(self, name: str) -> int:
        """The bytes of a leaf's compute tensor: its model block, or the
        whole leaf where it is gathered."""
        leaf = self.leaves[name]
        nbytes = math.prod(leaf.shape) * leaf.dtype.itemsize
        return nbytes if leaf.mdim is None or leaf.gathered else nbytes // self.model

    def whole_step_bytes(self) -> int:
        """The full bytes a step that gathers every leaf for the whole step
        holds at once: every gathered leaf's weights and gradients."""
        return 2 * sum(self._compute_bytes(k) for k in self._stepped())

    def held_bound(self) -> int:
        """The most full bytes this plan's step holds at once: the gathered
        leaves outside the periods, weights and gradients (those are whole
        till the step's end on every schedule), and with remat twice the
        largest period's (its weights and gradients in its backward); with
        remat off every period's weights and the largest period's
        gradients.  Without per-period leaves, :meth:`whole_step_bytes`."""
        if not self.per_period:
            return self.whole_step_bytes()
        sizes = [sum(self._compute_bytes(k) for k, _, _ in part) for part in self.periods]
        rest = sum(self._compute_bytes(k) for k in self._stepped() if k not in self.per_period)
        return 2 * rest + (2 * max(sizes) if self.cfg.remat else sum(sizes) + max(sizes))

    # -- the step's loss and gradients ----------------------------------------

    def _pend(self, names) -> None:
        """Count the full gradients of ``names`` held from now (once a step)."""
        for k in names:
            if k not in self._pending and k not in self._settled:
                self._pending[k] = self._compute_bytes(k)
                self._count(self._pending[k])

    def _settle(self, name: str) -> None:
        """A pending gradient is seen: its storage counts from now on."""
        self._count(-self._pending.pop(name, 0))
        self._settled.add(name)

    def _period_params(self, i: int, x: torch.Tensor):
        """Period ``i``'s compute tensors by block index and name in the
        block, and its input (the model's ``period_params``).  The loss
        follows the last period, so its gradients and the other gathered
        leaves' are counted held from its forward on; a period's backward,
        as it ends, counts the period before's (:class:`_PeriodInput`)."""
        x = _PeriodInput.apply(self, i, x)
        if i == len(self.periods) - 1:
            self._pend([k for k, _, _ in self.periods[i]]
                       + [k for k in self._stepped() if k not in self.per_period])
        out: Dict[int, Dict[str, torch.Tensor]] = {}
        for k, j, local in self.periods[i]:
            out.setdefault(j, {})[local] = _PeriodLeaf.apply(self, k, self._parts[k])
        return out, x

    def _period_grad(self, name: str, g: torch.Tensor) -> torch.Tensor:
        """A per-period leaf's full gradient synchronised."""
        self._settle(name)
        return self.sync_grad(name, self._held(g))

    def loss_and_grads(self, model: torch.nn.Module, params: Dict[str, torch.Tensor],
                       batch: Dict[str, torch.Tensor], *, use_kernel: Optional[bool] = None):
        """``(loss, grads)`` of this rank's rows: the loss (this rank's) and
        every leaf's gradient synchronised, the rank's block of it (by name,
        in the model's order).  The leaves outside ``per_period`` are
        gathered into the model for the step (:meth:`release_params` frees
        them); each period's are gathered inside the period and synchronised
        as its backward ends.  Call it under :meth:`scope`."""
        self.gather_params(model, params, [k for k in self._stepped() if k not in self.per_period])
        if not self.per_period:
            loss, grads = M.loss_and_grads(model, batch, use_kernel=use_kernel)
            return loss, self.sync_grads(grads)
        self._parts = {k: params[k].detach().requires_grad_() for k in self.per_period}
        self._settled = set()
        wrt = {k: self._parts.get(k, p) for k, p in model.named_parameters()}
        model.period_params = self._period_params
        try:
            loss, grads = M.loss_and_grads(model, batch, use_kernel=use_kernel, wrt=wrt)
            rest = self.sync_grads({k: g for k, g in grads.items() if k not in self.per_period})
        finally:
            model.period_params, self._parts = None, {}
            for k in list(self._pending):
                self._settle(k)
        return loss, {k: grads[k] if k in self.per_period else rest[k] for k in grads}

    # -- gradients and the loss -----------------------------------------------

    def _scatter_dim(self, g: torch.Tensor, dim: int, ways: int, group) -> torch.Tensor:
        src = g.movedim(dim, 0).contiguous()
        part = src.new_empty((src.shape[0] // ways, *src.shape[1:]))
        self.comm.reduce_scatter(part, src, group)
        return part.movedim(0, dim)

    def sync_grad(self, name: str, g: torch.Tensor) -> torch.Tensor:
        """One leaf's gradient on this rank averaged over the batch ranks
        and summed over the model axis where a model rank holds it in part:
        the block of a leaf cut over either axis, a replicated leaf whole."""
        leaf = self.leaves[name]
        if leaf.gathered and leaf.partial:
            g = self._scatter_dim(g, leaf.mdim, self.model, self.model_group)
        elif leaf.gathered:  # whole on every rank: this rank's block
            g = _cut(g, leaf.mdim, self.model, self.model_index).contiguous()
        elif leaf.partial:
            self.comm.all_reduce(g, self.model_group)
        if self.world > 1:
            if leaf.dim is None:
                self.comm.all_reduce(g, self.batch_group)
            else:
                g = self._scatter_dim(g, leaf.dim, self.shards, self.shard_group)
                if self.pod_group is not None:
                    self.comm.all_reduce(g, self.pod_group)
            g = g.div_(self.world)
        return g

    def sync_grads(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """:meth:`sync_grad` of every leaf in ``grads``, in turn; a full
        gradient of a gathered leaf is counted held until it is freed."""
        if self.ranks == 1:
            return grads
        stepped = set(self._stepped())
        for k, g in grads.items():
            if k in stepped:
                self._settle(k)
                self._held(g)
        return {k: self.sync_grad(k, g) for k, g in grads.items()}

    def moment_grads(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The gradients the moments are updated from: the synchronised
        blocks, or with whole moments (8-bit on a model axis) each model
        block gathered over ``model`` into the one-device layout."""
        if not self.whole_moments:
            return grads
        return {k: g if self.leaves[k].mdim is None else self.gather(k, g)
                for k, g in grads.items()}

    def init_state(self, params: Dict[str, torch.Tensor]):
        """``opt.init`` of this rank's ``params``; with whole moments of the
        whole leaves (shapes only: no whole parameter is made)."""
        if not self.whole_moments:
            return self.opt.init(params)
        return self.opt.init({k: p.new_empty(()).expand(self.leaves[k].shape)
                              for k, p in params.items()})

    def _owns(self, leaf: Leaf) -> bool:
        """This rank counts the leaf's gradient block in :meth:`sq_norm`:
        each block once over the mesh."""
        data_first = (self.pod_index if leaf.dim is not None else self.index) == 0
        return data_first and (leaf.mdim is not None or self.model_index == 0)

    def sq_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The sum of every squared gradient entry of the model, fp32: each
        block summed by the ranks that :meth:`_owns` it, over the mesh in one
        ``all_reduce``.  A world of one sums the squares as
        ``AdamW.update`` does."""
        g0 = next(iter(grads.values()))
        parts = [torch.sum(torch.square(g.float())) for k, g in grads.items()
                 if self._owns(self.leaves[k])]
        sq = (torch.sum(torch.stack(parts)) if parts
              else torch.zeros((), dtype=torch.float32, device=g0.device))
        if self.ranks > 1:
            self.comm.all_reduce(sq, self.mesh_group)
        return sq

    def mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The batch ranks' losses averaged: the one-device loss of the
        batch (a model group's ranks hold the same loss)."""
        if self.world == 1:
            return loss
        return self.comm.all_reduce(loss.clone(), self.batch_group).div_(self.world)

    # -- checkpoints ------------------------------------------------------------

    def _map(self, fn, tree):
        """``tree`` with every dict keyed by the parameter names mapped leaf
        by leaf through ``fn(name, leaf)``."""
        if isinstance(tree, dict):
            if set(tree) == set(self.leaves):
                return {k: fn(k, v) for k, v in tree.items()}
            return {k: self._map(fn, v) for k, v in tree.items()}
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(self._map(fn, v) for v in tree))
        return tree

    def full_state(self, tree):
        """A state tree (parameters, moments) with every block gathered,
        leaf by leaf, to the host in the one-device layout (a packed
        matrix unpacked): the one-device checkpoint's tree; 8-bit moments,
        ``(int8 blocks, scales)`` pairs, are whole on every rank already.
        Every rank calls it (its gathers are collectives)."""
        return self._map(lambda k, v: v if self._whole(k) or isinstance(v, tuple)
                         else self.gather(k, v).cpu(), tree)

    def shard_state(self, tree):
        """A one-device state tree (restored, on the host) cut to this
        rank's blocks."""
        return self._map(lambda k, v: v if self._whole(k) or isinstance(v, tuple)
                         else self.cut(k, torch.as_tensor(v)), tree)

    @property
    def writer(self) -> bool:
        """The rank that writes the mesh's checkpoints (the first)."""
        return self.index == 0 and self.model_index == 0

    def barrier(self) -> None:
        if self.ranks > 1:
            dist.barrier(group=self.mesh_group)

    # -- what the plan predicts -------------------------------------------------

    def at_rest_bytes(self) -> int:
        """Bytes a rank holds between steps: parameters (blocks of the
        leaves cut over data or model) and both moments (fp32 blocks, or
        the int8 blocks and their scales of the whole leaf)."""
        total = 0
        for leaf in self.leaves.values():
            numel = (math.prod(leaf.shape) // (1 if leaf.dim is None else self.shards)
                     // (1 if leaf.mdim is None else self.model))
            total += numel * leaf.dtype.itemsize
            if self.opt is not None and self.opt.quantize_states:
                blocks = -(-math.prod(leaf.shape) // 256)
                total += 2 * (blocks * 256 + blocks * 4)
            elif self.opt is not None:
                total += 2 * numel * 4
        return total

    def collective_bytes(self, kind: str, global_batch: int, seq_len: int) -> Dict[str, int]:
        """The result bytes, by kind, that one rank's collectives receive in
        one step of ``kind`` (``"train"``, ``"prefill"`` or ``"decode"``) of
        ``global_batch`` sequences of ``seq_len`` input tokens.  Over the
        batch axes: a train step's gathers (a period's leaf twice under
        remat: its forward and its recompute gather it), reduce-scatters and
        all_reduces (each leaf at its model block's bytes) and each MoE
        block's (every forward: twice a step under remat, whose recompute
        issues them again; the aux's gradient once).  Over the model axis:
        the gathered leaves' all_gather (a period's twice under remat, on a
        data axis larger than 1) and a KV leaf's reduce_scatter, the partial
        leaves' all_reduce, with 8-bit moments each model block's gradient
        gathered, and the activations' sums
        (:func:`.tensor_parallel.collectives`: the sub-blocks' and the
        embedding's ``g``, the mixers' two-way sums, the ``f``'s backward,
        the CE's reductions, the served logits' gather).  The norm's and the
        loss's scalars.  A serving step's batch the batch ranks do not
        divide is replicated over them (``batch_specs``' rule): nothing is
        issued over them."""
        out = dict.fromkeys(KINDS, 0)
        split = kind == "train" or global_batch % self.world == 0
        rows = global_batch // self.world if split else global_batch
        data = self.world > 1 and split
        if kind == "train":
            for name, leaf in self.leaves.items():
                whole = math.prod(leaf.shape) * leaf.dtype.itemsize
                nbytes = whole // (1 if leaf.mdim is None else self.model)
                # a period's leaf is gathered again by its remat recompute
                gathers = 2 if name in self.per_period and self.cfg.remat else 1
                if leaf.gathered:
                    out["all-gather"] += gathers * whole
                    if leaf.partial:
                        out["reduce-scatter"] += nbytes
                elif leaf.partial:
                    out["all-reduce"] += whole
                if self.whole_moments and leaf.mdim is not None:
                    out["all-gather"] += whole
                if not data:
                    continue
                if leaf.dim is None:
                    out["all-reduce"] += nbytes
                else:
                    out["all-gather"] += gathers * nbytes
                    out["reduce-scatter"] += nbytes // self.shards
                    if self.pods > 1:
                        out["all-reduce"] += nbytes // self.shards
            if self.ranks > 1 and self.opt.clip_norm is not None:
                out["all-reduce"] += 4
            if data:
                out["all-reduce"] += 4
        n_moe = self.cfg.n_periods * self.cfg.period.count("moe")
        if n_moe and data:
            tokens = rows * (1 if kind == "decode" else seq_len)
            forwards = 2 if kind == "train" and self.cfg.remat else 1
            with hints.use_mesh(self.mesh):
                per = moe.collectives(tokens, self.cfg.moe, self.world)
            for k, v in per.items():
                out[k] += n_moe * forwards * v
            if kind == "train":  # the aux's gradient through the mean probabilities
                out["all-reduce"] += n_moe * self.cfg.moe.num_experts * 4
        for k, v in tp.collectives(self.cfg, kind, rows, seq_len, self.model).items():
            out[k] += v
        out["total"] = sum(out[k] for k in KINDS)
        return out
