"""Tensor parallelism over a ``model`` axis of ranks, in the Megatron pattern.

Counterpart of the model-axis collectives that GSPMD inserts in the
reference (``src/repro/launch/train.py`` ``make_step`` and ``serve`` under
``with mesh:``, on ``make_local_mesh(model_parallel=k)``): there
``param_specs`` cuts heads, FFN columns, expert stacks and the vocabulary
over ``model`` and the partitioner adds what the cut needs.  Here each rank
of the model group holds its block of those leaves
(:class:`repro_torch.runtime.data_parallel.DataParallelPlan`), every rank
of the group holds the same rows, and the blocks issue the sums themselves:

* column-parallel in, row-parallel out: a sub-block (attention, MLA, the
  MLP, the MoE) reads its input through :func:`copy_to_model` (``f``:
  identity forward, ``all_reduce(SUM)`` of the gradient backward) and
  ends in :func:`reduce_from_model` (``g``: ``all_reduce(SUM)`` forward,
  identity backward), one ``all_reduce`` of the block's output;
* a vocabulary-parallel embedding (:func:`embed_lookup`: this rank's rows
  of the table, ids outside them masked, then ``g``) and unembedding (the
  logits of this rank's vocabulary block, after ``f``);
* a vocabulary-parallel cross-entropy (:func:`cross_entropy`,
  :func:`combine_chunks`): the row max by ``all_reduce(MAX)`` without
  gradient, then ``g`` of the sum of exponentials and ``g`` of the gold
  logit, whose gradient reaches only the rank that owns it.

``f`` and ``g`` are conjugate: a ``g`` whose backward summed again would
multiply every upstream gradient by the group's size, which is why the
MoE aux loss's two-way sum over the batch ranks
(``Collectives.all_reduce_grad``) is not used here.  Both go through the
plan's counting transport.  Without a model axis (``hints.model_shards()``
is None) every function here returns its input, so one device and the
data-parallel plan keep their bits.

The blocks run on the model block of each leaf they hold; a block reads
its local head, column or expert count from its weights' shapes.  Leaves
the model axis does not cut are replicated and computed on every rank of
the group; their gradients are whole there (the ``f`` sits after them),
except ``q_norm`` / ``k_norm``, which see only the rank's heads
(:func:`partial_leaf`).  Attention whose KV heads the axis does not divide
(reduced Qwen3-8B at k = 2: one KV head) has ``wk`` / ``wv`` cut in the
middle of a head by ``param_specs``: those leaves are gathered over the
model axis before the forward (:func:`uneven_kv_leaf`) and their gradients,
partial sums, reduce-scattered back.  ``param_specs`` cuts a packed SwiGLU
``w_in`` (``[gate | up]``) into contiguous column blocks, which would give
one rank every gate column; at rest a rank holds ``[gate_r | up_r]``
instead (:func:`pack_columns`), the same bytes in another order.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..models import hints

ITEM_14K = ("ROADMAP item 14k (tensor parallelism for the SSM mixers mamba, mlstm and slstm, "
            "the frames frontend and 8-bit moments)")
SUPPORTED = ("attn", "mla", "mlp", "moe")


def active() -> Optional[hints.ModelShards]:
    """The model axis entered by ``hints.use_model_shards``, when it has more
    than one rank; else None."""
    ms = hints.model_shards()
    return ms if ms is not None and ms.ranks > 1 else None


class _CopyToModel(torch.autograd.Function):
    """``f``: the input itself; backward, the gradient summed over the model
    group (each rank's part of it comes from its own heads or columns)."""

    @staticmethod
    def forward(ctx, comm, group, t):
        ctx.comm, ctx.group = comm, group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        ctx.comm.all_reduce(out, ctx.group)
        return None, None, out


class _ReduceFromModel(torch.autograd.Function):
    """``g``: the input summed over the model group; backward, the gradient
    itself (every rank of the group already holds all of it)."""

    @staticmethod
    def forward(ctx, comm, group, t):
        out = t.clone(memory_format=torch.contiguous_format)
        comm.all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return None, None, grad


def copy_to_model(t: torch.Tensor) -> torch.Tensor:
    """``f`` over the active model axis (``t`` itself without one)."""
    ms = active()
    return t if ms is None else _CopyToModel.apply(ms.comm, ms.group, t)


def reduce_from_model(t: torch.Tensor) -> torch.Tensor:
    """``g`` over the active model axis (``t`` itself without one)."""
    ms = active()
    return t if ms is None else _ReduceFromModel.apply(ms.comm, ms.group, t)


def max_over_model(t: torch.Tensor) -> torch.Tensor:
    """``t``'s elementwise maximum over the model axis, without gradient."""
    ms = active()
    if ms is None:
        return t
    out = t.detach().clone(memory_format=torch.contiguous_format)
    return ms.comm.all_reduce(out, ms.group, op=dist.ReduceOp.MAX)


def model_index() -> int:
    """This rank's index on the active model axis (0 without one)."""
    ms = active()
    return 0 if ms is None else ms.index


def vocab_start(local: int) -> int:
    """The first vocabulary id of this rank's block of ``local`` ids."""
    return model_index() * local


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``; under a model axis ``table`` is this rank's block of
    rows, the ids outside it give zero rows, and ``g`` sums the ranks'."""
    ms = active()
    if ms is None:
        return table[ids]
    local = ids - vocab_start(table.shape[0])
    inside = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(inside, local, 0)]
    return reduce_from_model(torch.where(inside[..., None], rows, 0.0))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token ``logsumexp - gold`` (fp32) of vocabulary-parallel logits
    ``(B, S, V / k)``, this rank's block: the three reductions over the
    model axis (over the whole vocabulary without one)."""
    mx = max_over_model(torch.amax(logits, dim=-1, keepdim=True).detach())
    sumexp = reduce_from_model(torch.sum(torch.exp(logits - mx), dim=-1))
    lse = torch.log(sumexp) + mx[..., 0]
    ids = vocab_start(logits.shape[-1]) + torch.arange(logits.shape[-1], device=logits.device)
    gold = reduce_from_model(torch.sum(torch.where(labels[..., None] == ids, logits, 0.0),
                                       dim=-1))
    return lse - gold


def combine_chunks(m_run: torch.Tensor, s_run: torch.Tensor,
                   gold: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked CE's running (max, sum-exp, gold) of this rank's
    vocabulary block, combined over the model axis: ``(lse, gold)``.
    Without a model axis, ``m_run + log(s_run)`` and ``gold``."""
    if active() is None:
        return m_run + torch.log(torch.clamp(s_run, min=1e-30)), gold
    mx = max_over_model(m_run)
    s = reduce_from_model(s_run * torch.exp(m_run - mx))
    return mx + torch.log(torch.clamp(s, min=1e-30)), reduce_from_model(gold)


# ---------------------------------------------------------------------------
# What the model axis does to a config and its leaves
# ---------------------------------------------------------------------------


def check_config(cfg, k: int) -> None:
    """Raise unless ``cfg`` runs on a model axis of ``k`` ranks: only token
    models of attention, MLA, MLP and MoE sub-blocks (else
    ``NotImplementedError``, item 14k), whose heads, FFN columns, experts and
    vocabulary ``k`` divides (else ``ValueError``)."""
    if k == 1:
        return
    other = sorted(set(cfg.period) - set(SUPPORTED))
    if other or cfg.frontend != "tokens":
        what = f"sub-blocks {other}" if other else f"a {cfg.frontend!r} frontend"
        raise NotImplementedError(f"{cfg.name}: {what} on a model axis of {k} is {ITEM_14K}")
    counts = {}
    if "attn" in cfg.period:
        counts["attention heads"] = cfg.n_heads
    if "mla" in cfg.period:
        counts["MLA heads"] = cfg.mla.n_heads
    if "mlp" in cfg.period:
        counts["MLP columns"] = cfg.d_ff
    if "moe" in cfg.period:
        counts["experts"] = cfg.moe.num_experts
        if cfg.moe.n_shared:
            counts["shared-expert columns"] = cfg.moe.n_shared * cfg.moe.d_ff
    counts["vocabulary ids"] = cfg.vocab_size
    for what, n in counts.items():
        if n % k:
            raise ValueError(f"{cfg.name}: {n} {what} do not split over a model axis of {k}")


def _leaf(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def uneven_kv_leaf(cfg, name: str, shape, k: int) -> bool:
    """An attention KV leaf (``wk``, ``wv``, ``bk``, ``bv``) of a config
    whose KV heads a model axis of ``k`` does not divide."""
    return (_leaf(name) in ("wk", "wv", "bk", "bv") and len(shape) <= 2
            and "attn" in cfg.period and cfg.n_kv_heads % k != 0)


def partial_leaf(name: str) -> bool:
    """A replicated leaf whose gradient each model rank holds only in part
    (its heads'): summed over the model axis."""
    return _leaf(name) in ("q_norm", "k_norm")


def packed_leaf(name: str, shape) -> bool:
    """A SwiGLU input matrix ``[gate | up]`` (the MLP's, the shared
    experts')."""
    return (_leaf(name) == "w_in" and len(shape) == 2) or _leaf(name) == "sw_in"


def pack_columns(t: torch.Tensor, k: int) -> torch.Tensor:
    """``[gate | up]`` (last dim 2f) reordered so that its ``k`` contiguous
    blocks are ``[gate_r | up_r]``, each rank's compute block."""
    lead, n = t.shape[:-1], t.shape[-1]
    return t.reshape(*lead, 2, k, n // (2 * k)).transpose(-3, -2).reshape(*lead, n)


def unpack_columns(t: torch.Tensor, k: int) -> torch.Tensor:
    """The inverse of :func:`pack_columns`: the one-device layout."""
    lead, n = t.shape[:-1], t.shape[-1]
    return t.reshape(*lead, k, 2, n // (2 * k)).transpose(-3, -2).reshape(*lead, n)


def collectives(cfg, kind: str, rows: int, seq: int, k: int) -> Dict[str, int]:
    """Result bytes of the model axis's activation collectives on one rank
    of ``rows`` sequences of ``seq`` tokens in one step of ``kind``
    (``"train"``, ``"prefill"``, ``"decode"``): the embedding's ``g`` and
    one ``g`` a sub-block (under remat in training the recompute issues
    them again, but for a period's last: torch's non-reentrant checkpoint
    stops recomputing after the last tensor the backward saved, and a
    period ends in that ``g`` and the residual add); in training also every ``f``'s backward (a
    sub-block's input; the MLA's latent and rotary key; the MoE's gates,
    fp32; the unembedding's input) and the CE's three fp32 reductions a
    token; in serving the ``all_gather`` of the last position's logits.
    The leaves' own model-axis collectives (gathered KV leaves, partial
    norms) are the plan's.  Sub-blocks other than attention, MLA, MLP and
    MoE (item 14k) add nothing here."""
    out = {"all-reduce": 0, "all-gather": 0}
    if k == 1:
        return out
    b = cfg.torch_dtype().itemsize
    T = rows * (1 if kind == "decode" else seq)
    act = T * cfg.d_model * b
    n = {t: cfg.n_periods * cfg.period.count(t) for t in SUPPORTED}
    blocks = sum(n.values())
    if kind == "train" and cfg.remat:
        blocks += blocks - (cfg.n_periods if cfg.period[-1] in SUPPORTED else 0)
    out["all-reduce"] += act * (1 + blocks)
    if kind == "train":
        back = act * (n["attn"] + n["mlp"] + n["moe"] + n["mla"] + 1)
        if n["moe"]:
            back += n["moe"] * T * cfg.moe.top_k * 4
        if n["mla"]:
            back += n["mla"] * T * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim) * b
        out["all-reduce"] += back + 3 * T * 4
    else:
        out["all-gather"] += rows * cfg.vocab_size * b
    return out
