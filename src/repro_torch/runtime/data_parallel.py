"""Data-parallel and sharded LM training and serving over ``torch.distributed``.

Counterpart of the reference's GSPMD placement in ``src/repro/launch/train.py``
(``make_sharded_train_state``: parameters and moments put into the
``param_specs`` / ``AdamW.state_specs`` shardings) for meshes whose ``model``
axis is 1.  One process a rank, each holding the same model code; the
batch's rows are split over the batch axes (``pod`` x ``data``, row-major,
the group of :func:`repro_torch.core.distributed.layout`).

:class:`DataParallelPlan` is the per-leaf plan.  A parameter whose spec
(after ``fit_spec``'s divisibility rule) cuts a dimension over ``data``, and
whose moments' spec cuts the same one, is *sharded*: between steps a rank
keeps only its contiguous block of that dimension, of the parameter and of
both fp32 moments.  Every other leaf is *replicated* (the int8 moments'
blocks cut across the parameter's shape, so with them every leaf is).  A
``pod`` axis replicates every parameter: the reference's specs name only
``data`` and ``model``.  A step (:func:`repro_torch.launch.train.make_step`)
runs

* :meth:`gather_params`: one ``all_gather_into_tensor`` a sharded leaf over
  the data group, into the model's full tensor (a shard dimension other
  than 0 goes through a contiguous staging tensor);
* the loss and ``torch.autograd.grad`` on the rank's rows;
* :meth:`sync_grads`: ``reduce_scatter_tensor(SUM)`` over data (then
  ``all_reduce(SUM)`` over pod) for a sharded leaf, ``all_reduce(SUM)`` over
  the batch group for a replicated one, each divided by the world (SUM and
  a division: ``ReduceOp.AVG`` is not every backend's);
* :meth:`sq_norm`: the global sum of squared gradients for ``clip_norm``,
  every shard once and every replicated leaf once, in one ``all_reduce``;
* ``AdamW.update`` on the shards, then :meth:`release_params` frees the full
  tensors again.

A world of one issues no collective and keeps the one-device step's bits:
every leaf is replicated, the parameters are the model's own tensors, and
:meth:`sq_norm` sums the squares as ``AdamW.update`` does.

:class:`Collectives` is the transport: each collective of the plan and of
the MoE across ranks (:mod:`repro_torch.models.moe`: the aux loss's two
``all_reduce`` and the global dispatch's ``all_gather`` of expert counts)
goes through it and is counted by kind in result bytes, as
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
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from .. import _device
from ..core import distributed
from ..models import hints, moe
from ..models import model as M

KINDS = ("all-reduce", "all-gather", "reduce-scatter")

MODEL_AXIS = ("a model axis larger than 1 (tensor-parallel training and serving, the "
              "reference's make_local_mesh(model_parallel=k) under GSPMD) is ROADMAP item 14j")


class _AllReduceSum(torch.autograd.Function):
    """``all_reduce(SUM)`` whose backward is the ``all_reduce(SUM)`` of the
    gradient (``torch.distributed.nn.functional.all_reduce``), both through
    a :class:`Collectives`, so both are counted."""

    @staticmethod
    def forward(ctx, comm, group, t):
        ctx.comm, ctx.group = comm, group
        out = t.clone(memory_format=torch.contiguous_format)
        comm.all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return None, None, _AllReduceSum.apply(ctx.comm, ctx.group, grad)


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

    def all_reduce(self, t: torch.Tensor, group) -> torch.Tensor:
        """``t`` summed over ``group``, in place."""
        self._issue("all-reduce", t, lambda: dist.all_reduce(t, op=dist.ReduceOp.SUM,
                                                            group=group))
        return t

    def all_reduce_grad(self, t: torch.Tensor, group) -> torch.Tensor:
        """``t`` summed over ``group`` (a new tensor); the gradient flows
        back through the same sum."""
        return _AllReduceSum.apply(self, group, t)

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


def check_mesh(mesh) -> Dict[str, int]:
    """The mesh's ``{axis: size}`` when this plan can run on it: its ranks
    lie on the ``pod``, ``data`` and ``model`` axes (a mesh of several ranks
    without them, or a ``DeviceMesh`` without axis names, raises
    ``ValueError``) and ``model`` is 1 (else ``NotImplementedError``, item
    14j)."""
    sizes = hints.mesh_axis_sizes(mesh)
    if sizes.get("model", 1) > 1:
        raise NotImplementedError(MODEL_AXIS)
    known = math.prod(sizes.get(a, 1) for a in ("pod", "data", "model"))
    if known != mesh.size():
        raise ValueError(f"a mesh of {mesh.size()} devices with axes {sizes or 'unnamed'}: "
                         "its ranks must lie on the pod, data and model axes")
    return sizes


def mesh_device(mesh, device=None) -> torch.device:
    """The device this rank runs on: ``device`` without a mesh (``None``:
    the CUDA card), else the mesh's device type, on the card the rank's
    current device.  The mesh must pass :func:`check_mesh`, and a mesh of
    several ranks needs ``torch.distributed`` initialised (one process a
    rank)."""
    if mesh is None:
        return _device.resolve(device)
    check_mesh(mesh)
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
    model_share: int  # the ways its spec cuts it over ``model`` (1 on a run's mesh)


def _axes(entry) -> Tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


def _data_dim(spec) -> Optional[int]:
    for dim, entry in enumerate(spec):
        if "data" in _axes(entry):
            return dim
    return None


def _model_share(spec, sizes: Dict[str, int]) -> int:
    return math.prod(sizes.get("model", 1) for entry in spec if "model" in _axes(entry))


class DataParallelPlan:
    """The per-leaf plan of ``cfg``'s parameters (a model or a dict of
    name -> tensor, on any device, ``meta`` included) on ``mesh``: sharded
    over ``data`` or replicated, as ``param_specs`` and ``opt.state_specs``
    cut them.  ``opt=None`` plans serving: every leaf replicated, as the
    reference's serve leaves its parameters.  ``mesh=None`` is a world of
    one.  On a ``DeviceMesh`` the plan runs (its groups are the mesh's);
    on an :class:`~repro_torch.launch.mesh.AbstractMesh` it only counts,
    over the data axes, each leaf's block of a ``model`` axis (whose own
    collectives are left to item 14j)."""

    def __init__(self, cfg, params_like, mesh=None, opt=None):
        runs = mesh is not None and hasattr(mesh, "get_group")
        sizes = {} if mesh is None else (check_mesh(mesh) if runs
                                         else hints.mesh_axis_sizes(mesh))
        self.cfg, self.mesh, self.opt = cfg, mesh, opt
        self.shards = sizes.get("data", 1)  # ways a sharded leaf is cut
        self.pods = sizes.get("pod", 1)
        self.world = self.shards * self.pods  # ranks holding separate rows
        params = dict(params_like.named_parameters()) if isinstance(
            params_like, torch.nn.Module) else dict(params_like)
        dims, shares = dict.fromkeys(params), dict.fromkeys(params, 1)
        if self.shards > 1 and opt is not None:
            pspecs = M.param_specs(cfg, params, mesh)
            mu_specs = opt.state_specs(pspecs).mu
            dims = {k: _data_dim(s) if mu_specs[k] == s else None for k, s in pspecs.items()}
            shares = {k: _model_share(s, sizes) for k, s in pspecs.items()}
        self.leaves = {k: Leaf(tuple(p.shape), p.dtype, dims[k], shares[k])
                       for k, p in params.items()}
        self.comm = Collectives()
        self.index = self.shard_index = self.pod_index = 0
        self.batch_group = self.shard_group = self.pod_group = None
        if runs and self.world > 1:
            batch = distributed.layout(mesh, M.batch_axes(mesh))
            data = distributed.layout(mesh, ("data",))
            self.batch_group, self.index = batch.group, batch.index
            self.shard_group, self.shard_index = data.group, data.index
            if self.pods > 1:
                pod = distributed.layout(mesh, ("pod",))
                self.pod_group, self.pod_index = pod.group, pod.index

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
        """The mesh and the token split (none for a world of one) a step
        runs under: the reference's ``with mesh:``."""
        shards = (None if self.world == 1 else
                  hints.TokenShards(self.batch_group, self.world, self.index, self.comm))
        with hints.use_mesh(self.mesh), hints.use_token_shards(shards):
            yield

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``t`` (dim 0) in rank order."""
        if self.world == 1:
            return t
        out = t.new_empty((t.shape[0] * self.world, *t.shape[1:]))
        return self.comm.all_gather(out, t.contiguous(), self.batch_group)

    # -- parameters -----------------------------------------------------------

    def sharded(self):
        return [k for k, leaf in self.leaves.items() if leaf.dim is not None]

    def cut(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of a leaf (its own storage) or, replicated, the
        leaf itself."""
        dim = self.leaves[name].dim
        if dim is None:
            return full
        n = full.shape[dim] // self.shards
        return full.narrow(dim, self.shard_index * n, n).clone(
            memory_format=torch.contiguous_format)

    def gather(self, name: str, part: torch.Tensor) -> torch.Tensor:
        """The full leaf from every rank's block (one ``all_gather``)."""
        dim = self.leaves[name].dim
        if dim is None:
            return part
        src = part.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] * self.shards, *src.shape[1:]))
        self.comm.all_gather(out, src, self.shard_group)
        return out if dim == 0 else out.movedim(0, dim).contiguous()

    def shard_params(self, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
        """The rank's parameters at rest: the model's own tensor of a
        replicated leaf, its block of a sharded one; the model's full tensors
        of the sharded leaves are freed (:meth:`release_params`)."""
        out = {k: p if self.leaves[k].dim is None else self.cut(k, p.detach())
               for k, p in model.named_parameters()}
        self.release_params(model)
        return out

    def adopt(self, model: torch.nn.Module, params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """:meth:`shard_params` for a restored tree of this rank's leaves:
        replicated leaves are copied into the model, blocks kept."""
        live = dict(model.named_parameters())
        out = {}
        with torch.no_grad():
            for k, p in live.items():
                src = torch.as_tensor(params[k])
                if self.leaves[k].dim is None:
                    out[k] = p.copy_(src.to(dtype=p.dtype))
                else:
                    out[k] = src.to(device=p.device, dtype=p.dtype).contiguous()
        return out

    @torch.no_grad()
    def gather_params(self, model: torch.nn.Module, params: Dict[str, torch.Tensor]) -> None:
        """Give the model its full tensors of the sharded leaves."""
        live = dict(model.named_parameters())
        for k in self.sharded():
            live[k].data = self.gather(k, params[k])

    def release_params(self, model: torch.nn.Module) -> None:
        """Free the model's full tensors of the sharded leaves."""
        live = dict(model.named_parameters())
        for k in self.sharded():
            live[k].data = live[k].data.new_empty(0)

    # -- gradients and the loss -----------------------------------------------

    def sync_grads(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Every rank's gradients averaged: a sharded leaf's block, a
        replicated leaf whole."""
        if self.world == 1:
            return grads
        out = {}
        for k, g in grads.items():
            dim = self.leaves[k].dim
            if dim is None:
                self.comm.all_reduce(g, self.batch_group)
            else:
                src = g.movedim(dim, 0).contiguous()
                part = src.new_empty((src.shape[0] // self.shards, *src.shape[1:]))
                self.comm.reduce_scatter(part, src, self.shard_group)
                if self.pod_group is not None:
                    self.comm.all_reduce(part, self.pod_group)
                g = part.movedim(0, dim)
            out[k] = g.div_(self.world)
        return out

    def sq_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The sum of every squared gradient entry of the model, fp32: this
        rank's blocks (on the first pod) and the replicated leaves (on rank
        0), summed over the ranks in one ``all_reduce``.  A world of one
        sums the squares as ``AdamW.update`` does."""
        g0 = next(iter(grads.values()))
        parts = [torch.sum(torch.square(g.float())) for k, g in grads.items()
                 if (self.pod_index if self.leaves[k].dim is not None else self.index) == 0]
        sq = (torch.sum(torch.stack(parts)) if parts
              else torch.zeros((), dtype=torch.float32, device=g0.device))
        if self.world > 1:
            self.comm.all_reduce(sq, self.batch_group)
        return sq

    def mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The ranks' losses averaged: the one-device loss of the batch."""
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
        leaf by leaf, to the host: the one-device checkpoint's tree.  Every
        rank calls it (its gathers are collectives)."""
        def full(k, v):
            if self.leaves[k].dim is None:
                return v
            return self.gather(k, v).cpu()

        return self._map(full, tree)

    def shard_state(self, tree):
        """A one-device state tree (restored, on the host) cut to this
        rank's blocks."""
        return self._map(lambda k, v: v if self.leaves[k].dim is None else
                         self.cut(k, torch.as_tensor(v)), tree)

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier(group=self.batch_group)

    # -- what the plan predicts -------------------------------------------------

    def at_rest_bytes(self) -> int:
        """Bytes a rank holds between steps: parameters (blocks of the
        sharded leaves) and both moments (fp32 blocks, or the int8 blocks
        and their scales)."""
        total = 0
        for leaf in self.leaves.values():
            numel = math.prod(leaf.shape) // (1 if leaf.dim is None else self.shards)
            total += numel * leaf.dtype.itemsize
            if self.opt is not None and self.opt.quantize_states:
                blocks = -(-numel // 256)
                total += 2 * (blocks * 256 + blocks * 4)
            elif self.opt is not None:
                total += 2 * numel * 4
        return total

    def collective_bytes(self, kind: str, global_batch: int, seq_len: int) -> Dict[str, int]:
        """The result bytes, by kind, that one rank's collectives receive in
        one step of ``kind`` (``"train"``, ``"prefill"`` or ``"decode"``) of
        ``global_batch`` sequences of ``seq_len`` input tokens: a train
        step's gathers, reduce-scatters and all_reduces (the norm's and the
        loss's scalars included), and each MoE block's (every forward:
        twice a step under remat, whose recompute issues them again; the
        aux's gradient once).  On a mesh whose ``model`` axis is above 1
        (an abstract one: the dry run's) a leaf's bytes are those of its
        ``model`` block, what a device of that mesh moves over the data
        axes; the model axis's own collectives are not counted (item 14j).
        A serving step's batch the ranks do not divide is replicated
        (``batch_specs``' rule): nothing is issued."""
        out = dict.fromkeys(KINDS, 0)
        if self.world == 1 or (kind != "train" and global_batch % self.world):
            out["total"] = 0
            return out
        if kind == "train":
            for leaf in self.leaves.values():
                nbytes = math.prod(leaf.shape) * leaf.dtype.itemsize // leaf.model_share
                if leaf.dim is None:
                    out["all-reduce"] += nbytes
                else:
                    out["all-gather"] += nbytes
                    out["reduce-scatter"] += nbytes // self.shards
                    if self.pods > 1:
                        out["all-reduce"] += nbytes // self.shards
            out["all-reduce"] += 4 * (2 if self.opt.clip_norm is not None else 1)
        tokens = global_batch // self.world * (1 if kind == "decode" else seq_len)
        n_moe = self.cfg.n_periods * self.cfg.period.count("moe")
        if n_moe:
            forwards = 2 if kind == "train" and self.cfg.remat else 1
            with hints.use_mesh(self.mesh):
                per = moe.collectives(tokens, self.cfg.moe, self.world)
            for k, v in per.items():
                out[k] += n_moe * forwards * v
            if kind == "train":  # the aux's gradient through the mean probabilities
                out["all-reduce"] += n_moe * self.cfg.moe.num_experts * 4
        out["total"] = sum(out[k] for k in KINDS)
        return out
