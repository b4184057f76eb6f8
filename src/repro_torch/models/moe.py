"""Mixture-of-Experts FFN: top-k router and sort-based capacity dispatch.

Counterpart of ``src/repro/models/moe.py``, with its static shapes: the
expert buffer is ``(E, C, d)`` whatever the routing, a pair past its
expert's capacity goes to a drop row at ``E * C``, and nothing is read back
to the host.  One call runs the reference's six steps, each a function of
its own here:

1. :func:`route`: router logits, softmax, top-k (ties to the lower expert
   id, as ``jax.lax.top_k``) and the renormalized gates;
2-3. :func:`dispatch_plan`: the (token, choice) pairs stable-sorted by
   expert, each pair's position within its expert, the kept pairs' slots;
4. :func:`dispatch`: the ``(E * C, d)`` buffer, each row gathered from its
   token;
5. :func:`experts`: the grouped SwiGLU, two ``torch.bmm`` over the experts
   (the JAX package leaves this product to an XLA einsum, not a kernel);
6. :func:`combine`: each pair's expert output gathered back and weighted by
   its gate, a token's k choices summed in a fixed order.

No step adds floats with atomics, so a call gives the same bits every time
on the card: the reference's two scatter-adds become row gathers (kept
slots are unique, so the expert buffer has one source a row, and a token's
k outputs are gathered in token-major order and summed in turn).  Expert
counts (the aux loss, the positions) are integer scatter-adds, which are
exact in any order; ``torch.bincount`` would read its input's maximum back
to the host.

``dispatch="rowwise"`` is the reference's per-data-shard dispatch: under a
mesh (:func:`.hints.use_mesh`) the T tokens are viewed as (rows, T / rows),
``rows`` the product of the mesh's ``pod`` and ``data`` sizes, and each row
is planned, dispatched and combined on its own at ``capacity(T / rows)``;
routing and the aux loss stay global, as the reference's.  Without a mesh
(or where rows do not divide T) there is one row, which is the global
dispatch at ``capacity(T)``, the reference's own single-device identity,
and the same code path and bits as ``dispatch="global"``.

Across ranks (:func:`.hints.use_token_shards`: each process holds an equal
block of the batch's rows, so of its tokens in batch-major order), a rank's
tokens are its share of the reference's plan over every rank's tokens
(:func:`layout`): one row of the rowwise dispatch at ``capacity(T_all /
rows)``; or, where one row spans the ranks (the global dispatch), positions
that continue those of the lower ranks (the expert counts ``all_gather``ed)
at ``capacity(T_all)``, which keeps exactly the one-device plan's pairs in
an ``(E, capacity(T_all), d)`` buffer of which the rank fills its own
slots.  A dropless plan keeps every pair whatever the positions, so it is
planned locally.  The aux loss is the global one: the mean probabilities'
numerators are summed by an ``all_reduce`` whose backward is one too, the
expert counts by a plain one.

Under a model axis (:mod:`repro_torch.runtime.tensor_parallel`: expert
parallelism) a rank holds ``E / k`` experts, the stacks' block of their
leading axis, and its block of the shared experts' columns.  Every rank of
the model group holds the same tokens, and the router is replicated, so
each computes the same routes and the same plan (the normed input is the
output of the previous block's ``all_reduce``); no all-to-all is needed.
:func:`dispatch` fills only this rank's experts' slots, :func:`combine`
sums only their gated outputs, and ``g`` sums the ranks'.  The expert input
and the gates go through ``f``: each rank's combine sees only its experts'
gates, so their gradients (and through them the router's) are summed over
the axis, while the aux loss, the same on every rank, stays outside any
model-axis sum and is counted once.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..runtime import tensor_parallel as tp
from . import hints, layers


class MoEDims(NamedTuple):
    num_experts: int
    top_k: int
    d_ff: int  # per-expert hidden dim
    n_shared: int = 0  # shared (always-on) experts
    capacity_factor: float = 1.25
    aux_coef: float = 0.01
    # "global": one (E, C, d) buffer; "rowwise": one per data shard (one row
    # without a mesh, which is the global dispatch)
    dispatch: str = "global"


def rows_of(T: int, dims: MoEDims) -> int:
    """Rows of the rowwise dispatch for ``T`` tokens (every rank's, under
    token shards): the active mesh's ``pod`` x ``data`` size where it
    divides T, else 1 (and 1 for the global dispatch)."""
    if dims.dispatch != "rowwise":
        return 1
    sizes = hints.axis_sizes()
    rows = sizes.get("pod", 1) * sizes.get("data", 1)
    return rows if T % rows == 0 else 1


class Layout(NamedTuple):
    """How a rank plans its tokens: ``rows`` rows of its own, each at
    ``C`` slots an expert, or (``spans``) one row shared with the other
    ranks, its positions continuing theirs."""
    rows: int
    C: int
    spans: bool


def layout(T: int, dims: MoEDims, ranks: int = 1) -> Layout:
    """The plan of ``T`` tokens of this rank when ``ranks`` ranks hold equal
    shares of the batch: the reference's rows over the ``T * ranks`` tokens
    (:func:`rows_of`), each rank holding ``rows / ranks`` of them, or one
    row spanning every rank."""
    T_all = T * ranks
    rows = rows_of(T_all, dims)
    if rows % ranks == 0:
        local = rows // ranks
        return Layout(local, capacity(T // local, dims), False)
    if rows != 1:
        raise ValueError(f"{rows} dispatch rows over {ranks} ranks: a rank must hold whole rows")
    if dims.capacity_factor <= 0:  # dropless: every pair is kept, whatever its position
        return Layout(1, capacity(T, dims), False)
    return Layout(1, capacity(T_all, dims), True)


def collectives(T: int, dims: MoEDims, ranks: int) -> Dict[str, int]:
    """Result bytes of the collectives one forward of a MoE block issues on
    a rank of ``T`` tokens among ``ranks``: the aux loss's ``all_reduce`` of
    the probabilities' sums (fp32) and of the counts (int64), and the
    ``all_gather`` of the counts where a row spans the ranks."""
    if ranks == 1:
        return {}
    E = dims.num_experts
    out = {"all-reduce": E * 4 + E * 8}
    if layout(T, dims, ranks).spans:
        out["all-gather"] = ranks * E * 8
    return out


def capacity(T: int, dims: MoEDims) -> int:
    """Slots an expert holds for ``T`` tokens: dropless (``C = T``) at
    ``capacity_factor <= 0``, else ``ceil(T k / E * factor)``; padded to a
    multiple of 8."""
    if dims.capacity_factor <= 0:
        c = T
    else:
        c = math.ceil(T * dims.top_k / dims.num_experts * dims.capacity_factor)
    return max(8, ((c + 7) // 8) * 8)


class Plan(NamedTuple):
    """Where each (token, choice) pair goes, pairs in token-major order."""
    keep: torch.Tensor  # (T, k) bool: within its expert's capacity
    slot: torch.Tensor  # (T, k) row of the (E*C, d) buffer; E*C for a dropped pair
    src: torch.Tensor  # (E*C,) the token in each row of the buffer; T for an empty row


def expert_counts(eidx: torch.Tensor, E: int) -> torch.Tensor:
    """Pairs routed to each expert, (E,) int64: an integer scatter-add,
    exact in any order and with no read back to the host."""
    flat = eidx.reshape(-1)
    return torch.zeros(E, dtype=torch.int64, device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat))


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values, ties to
    the lower index (a stable descending sort; ``torch.topk`` promises no
    order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def gates_at(probs: torch.Tensor, eidx: torch.Tensor) -> torch.Tensor:
    """The chosen experts' probabilities renormalized over the k choices."""
    gates = torch.gather(probs, -1, eidx)
    return gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)


def route(h: torch.Tensor, router: torch.Tensor,
          dims: MoEDims) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Step 1 for ``h`` (T, d): ``(probs (T, E) fp32, gates (T, k) fp32,
    eidx (T, k) int64)``."""
    probs = torch.softmax((h @ router).float(), dim=-1)
    _, eidx = top_k(probs, dims.top_k)
    return probs, gates_at(probs, eidx), eidx


def aux_loss(probs: torch.Tensor, eidx: torch.Tensor, dims: MoEDims,
             shards: Optional[hints.TokenShards] = None) -> torch.Tensor:
    """Switch-style load balance: ``aux_coef * E * sum(mean prob x routed
    fraction)`` over the experts; with ``shards``, both means over every
    rank's tokens."""
    E = dims.num_experts
    if shards is None:
        me = probs.mean(dim=0)
        ce = expert_counts(eidx, E).float() / eidx.numel()
    else:
        me = shards.comm.all_reduce_grad(probs.sum(dim=0), shards.group) / (
            probs.shape[0] * shards.ranks)
        counts = shards.comm.all_reduce(expert_counts(eidx, E), shards.group)
        ce = counts.float() / (eidx.numel() * shards.ranks)
    return dims.aux_coef * E * torch.sum(me * ce)


def global_offsets(eidx: torch.Tensor, E: int, shards: hints.TokenShards) -> torch.Tensor:
    """(E,) pairs the lower ranks route to each expert: where this rank's
    positions start in the global token order (one ``all_gather``)."""
    counts = expert_counts(eidx, E)
    every = counts.new_empty((shards.ranks * E,))
    shards.comm.all_gather(every, counts, shards.group)
    return every.view(shards.ranks, E)[:shards.index].sum(dim=0)


def dispatch_plan(eidx: torch.Tensor, E: int, C: int,
                  offset: Optional[torch.Tensor] = None) -> Plan:
    """Steps 2-3: sort the pairs by expert (stable, so an expert's pairs stay
    in token order), rank them within their expert, keep the first ``C`` of
    each, and map the kept slots back to their tokens.  ``offset`` (E,)
    starts each expert's positions there (:func:`global_offsets`)."""
    T, k = eidx.shape
    flat_e = eidx.reshape(T * k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = expert_counts(flat_e, E)
    seg_start = torch.cumsum(counts, 0) - counts  # first sorted rank of each expert
    rank = torch.arange(T * k, device=flat_e.device)
    pos_in_e = rank - seg_start[sorted_e]
    if offset is not None:
        pos_in_e = pos_in_e + offset[sorted_e]
    keep = pos_in_e < C
    slot = torch.where(keep, sorted_e * C + pos_in_e, E * C)
    # the buffer's rows by source token: kept slots are unique, so this
    # integer scatter has one writer a row (the drop row E*C is cut off)
    src = torch.full((E * C + 1,), T, dtype=order.dtype, device=order.device)
    src = src.scatter(0, slot, order // k)[:E * C]
    # back to token-major order: the inverse of the sort's permutation
    back = torch.empty_like(order).scatter_(0, order, rank)
    return Plan(keep=keep[back].reshape(T, k), slot=slot[back].reshape(T, k), src=src)


def dispatch(h: torch.Tensor, plan: Plan, E: int, C: int, first: int = 0) -> torch.Tensor:
    """Step 4: the ``(E, C, d)`` buffer of experts ``first .. first + E - 1``
    (every expert by default), each row gathered from its token (a zero row
    where no pair filled it).  The reference scatter-adds the kept pairs
    into zeros; kept slots are unique, so a row gather gives the same buffer
    with no adds at all."""
    d = h.shape[-1]
    rows = torch.cat([h, h.new_zeros((1, d))])
    return rows[plan.src[first * C:(first + E) * C]].reshape(E, C, d)


def experts(buf: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """Step 5: every expert's SwiGLU over its ``C`` rows, ``(E, C, d)``."""
    gate, up = torch.bmm(buf, w_in).chunk(2, dim=-1)
    return torch.bmm(F.silu(gate) * up, w_out)


def combine(y: torch.Tensor, gates: torch.Tensor, plan: Plan, first: int = 0) -> torch.Tensor:
    """Step 6: ``(T, d)``, each pair's expert output gathered in token-major
    order and weighted by its gate (0 for a dropped pair, and for a pair of
    an expert outside ``y``'s, which holds experts ``first ..``), a token's
    k choices summed in choice order in ``y``'s type (the reference adds
    them into a zero buffer of that type, by scatter-add)."""
    T, k = gates.shape
    E, C, d = y.shape
    flat = y.reshape(E * C, d)
    slot = plan.slot - first * C
    keep = plan.keep & (slot >= 0) & (slot < E * C)
    pair_out = torch.where(keep[..., None],
                           flat[torch.clamp(slot, min=0, max=E * C - 1)], 0.0)
    weighted = pair_out * gates[..., None].to(y.dtype)
    out = weighted[:, 0]
    for j in range(1, k):
        out = out + weighted[:, j]
    return out


class MoE(layers.Stateless, nn.Module):
    """Pre-norm MoE sub-block: ``(x + experts(norm(x)) [+ shared], aux)``.
    Leaves as the reference's: ``norm_scale``, ``router`` (d, E), ``w_in``
    (E, d, 2f) ``[gate | up]``, ``w_out`` (E, f, d), and ``sw_in`` /
    ``sw_out`` for the shared experts."""

    def __init__(self, d_model: int, dims: MoEDims, dtype, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        if dims.dispatch not in ("global", "rowwise"):
            raise ValueError(f"unknown MoE dispatch {dims.dispatch!r}")
        self.dims = dims
        E, f = dims.num_experts, dims.d_ff
        self.norm_scale = layers.param(layers.init_rms_scale(d_model, dtype, device))
        self.router = layers.dense_param(gen, (d_model, E), dtype, device)
        self.w_in = layers.dense_param(gen, (E, d_model, 2 * f), dtype, device, in_axis=1)
        self.w_out = layers.dense_param(gen, (E, f, d_model), dtype, device, in_axis=1)
        if dims.n_shared > 0:
            fs = dims.n_shared * f
            self.sw_in = layers.dense_param(gen, (d_model, 2 * fs), dtype, device)
            self.sw_out = layers.dense_param(gen, (fs, d_model), dtype, device)

    def forward(self, x: torch.Tensor, positions: Optional[torch.Tensor] = None,
                use_kernel: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, S, d_model); positions and use_kernel are unused (the
        sub-block interface).  Returns (residual output, aux loss fp32)."""
        B, S, d = x.shape
        T = B * S
        E = self.dims.num_experts
        shards = hints.token_shards()
        rows, C, spans = layout(T, self.dims, 1 if shards is None else shards.ranks)
        h = layers.rms_norm(x, self.norm_scale).reshape(T, d)
        probs, gates, eidx = route(h, self.router, self.dims)
        aux = aux_loss(probs, eidx, self.dims, shards)
        first = self.w_in.shape[0] * tp.model_index()  # this rank's first expert
        h, gates = tp.copy_to_model(h), tp.copy_to_model(gates)
        if rows == 1:
            offset = global_offsets(eidx, E, shards) if spans else None
            plan = dispatch_plan(eidx, E, C, offset)
            y = experts(dispatch(h, plan, self.w_in.shape[0], C, first), self.w_in, self.w_out)
            out = combine(y, gates, plan, first)
        else:
            out = self._rowwise(h, gates, eidx, rows, C, first)
        if self.dims.n_shared > 0:
            out = out + layers.swiglu(h, self.sw_in, self.sw_out)
        return x + tp.reduce_from_model(out).reshape(B, S, d), aux

    def _rowwise(self, h: torch.Tensor, gates: torch.Tensor, eidx: torch.Tensor,
                 rows: int, C: int, first: int = 0) -> torch.Tensor:
        """Steps 2-6 row by row: each row of ``T / rows`` tokens gets its own
        plan, its own (E, C, d) buffer of this rank's experts (from
        ``first``) and its own combine; the experts run once over every
        row's buffer (the reference's ``recd,edf->recf`` einsum), the rows
        laid end to end along each expert's slots."""
        T, d = h.shape
        E, El = self.dims.num_experts, self.w_in.shape[0]
        Tr = T // rows
        # rows over the batch axes, as the reference pins them (a no-op here)
        hr = hints.constrain_batch(h.reshape(rows, Tr, d))
        parts = [slice(r * Tr, (r + 1) * Tr) for r in range(rows)]
        plans = [dispatch_plan(eidx[p], E, C) for p in parts]
        buf = torch.stack([dispatch(hr[r], plans[r], El, C, first) for r in range(rows)])
        y = experts(buf.transpose(0, 1).reshape(El, rows * C, d), self.w_in, self.w_out)
        y = y.reshape(El, rows, C, d).transpose(0, 1)  # (rows, El, C, d)
        out = torch.stack([combine(y[r], gates[p], plans[r], first)
                           for r, p in enumerate(parts)])
        return out.reshape(T, d)
