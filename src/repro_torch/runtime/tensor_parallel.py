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
its local head, column, channel or expert count from its weights' shapes.
Leaves the model axis does not cut are replicated and computed on every
rank of the group; their gradients are whole there (the ``f`` sits after
them), except those a rank uses only in part (:func:`partial_leaf`: the
attention's ``q_norm`` / ``k_norm``, the mLSTM's gate weights and biases and
its ``out_norm``, the sLSTM's recurrent ``r`` and bias ``b``), whose
gradients are summed over the axis.  Attention whose KV heads the axis does
not divide (reduced Qwen3-8B at k = 2: one KV head) has ``wk`` / ``wv`` cut
in the middle of a head by ``param_specs``: those leaves are gathered over
the model axis before the forward (:func:`uneven_kv_leaf`) and their
gradients, partial sums, reduce-scattered back.  A frames frontend's
``embed_proj`` is gathered the same way, the residual stream being whole on
every rank; its gradient is whole there too, so a rank keeps its block of
it.  ``param_specs`` cuts a packed matrix -- a SwiGLU ``w_in`` (``[gate |
up]``), a Mamba ``w_in`` or an mLSTM ``w_up`` (``[x | z]``), an sLSTM ``w``
(``[i | f | z | o]``) -- into contiguous column blocks, which would give one
rank whole parts; at rest a rank holds ``[gate_r | up_r]`` (each part's
block r) instead (:func:`pack_columns`), the same bytes in another order.
An mLSTM's per-head ``wq`` / ``wk`` / ``wv`` (H, dh, dh), which the spec cuts
within every head, are held as the rank's H / k whole heads.

The SSM mixers (:mod:`repro_torch.models.ssm`) cut their channels (Mamba's
``d_inner``) or heads (mLSTM, sLSTM) over the axis between ``f`` and
``g``.  Where a rank's channels give a partial sum that every rank goes on
to use -- Mamba's ``xin @ w_x`` (the step sizes' low rank and B, C), the
mLSTM's gates ``xc @ w_if`` and the sum of squares of its ``out_norm`` over
the whole ``d_inner`` -- :func:`sum_over_model` sums it both ways: its
gradient is partial on every rank too, so ``g`` alone would drop the other
ranks' parts.  An sLSTM's recurrence is block-diagonal by head, so its time
loop needs no collective.  A vocabulary the axis does not divide (HuBERT's
504 classes over 16) is not cut (``param_specs``' divisibility rule): the
embedding and head are whole on every rank, and the embedding, the
unembedding and the CE are the plain ones (:func:`vocab_cut`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..models import hints

BLOCKS = ("attn", "mla", "mlp", "moe", "mamba", "mlstm", "slstm")


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


def sum_over_model(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the active model axis both ways (``all_reduce(SUM)``
    forward and of the gradient backward, each counted): a partial sum every
    rank goes on to use as its own (``t`` itself without one)."""
    ms = active()
    return t if ms is None else ms.comm.all_reduce_grad(t, ms.group)


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


def local_block(t: torch.Tensor, dim: int, local: int) -> torch.Tensor:
    """This rank's block of ``local`` entries of a whole leaf ``t`` along
    ``dim`` (``t`` itself without a model axis)."""
    return t if active() is None else t.narrow(dim, model_index() * local, local)


def local_parts(t: torch.Tensor, parts: int) -> torch.Tensor:
    """This rank's ``[p0_r | p1_r | ...]`` of a whole leaf ``t`` whose last
    dim packs ``parts`` equal parts (an sLSTM bias ``[i | f | z | o]``)."""
    ms = active()
    if ms is None:
        return t
    return pack_columns(t, ms.ranks, parts).chunk(ms.ranks, dim=-1)[ms.index]


def vocab_cut(vocab: int) -> bool:
    """The vocabulary of ``vocab`` ids is cut over the active model axis:
    there is one and its size divides it (``param_specs``' rule; else the
    embedding and the head are whole on every rank)."""
    ms = active()
    return ms is not None and vocab % ms.ranks == 0


def vocab_start(local: int) -> int:
    """The first vocabulary id of this rank's block of ``local`` ids."""
    return model_index() * local


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """``table[ids]``; where the model axis cuts the ``vocab`` ids, ``table``
    is this rank's block of rows, the ids outside it give zero rows, and
    ``g`` sums the ranks'."""
    if not vocab_cut(vocab):
        return table[ids]
    local = ids - vocab_start(table.shape[0])
    inside = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(inside, local, 0)]
    return reduce_from_model(torch.where(inside[..., None], rows, 0.0))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int) -> torch.Tensor:
    """Per-token ``logsumexp - gold`` (fp32) of logits ``(B, S, V / k)``,
    this rank's block of a cut vocabulary of ``vocab`` ids: the three
    reductions over the model axis (over the whole vocabulary where it is
    not cut)."""
    cut = vocab_cut(vocab)
    mx = torch.amax(logits, dim=-1, keepdim=True).detach()
    if cut:
        mx = max_over_model(mx)
    sumexp = torch.sum(torch.exp(logits - mx), dim=-1)
    if cut:
        sumexp = reduce_from_model(sumexp)
    lse = torch.log(sumexp) + mx[..., 0]
    first = vocab_start(logits.shape[-1]) if cut else 0
    ids = first + torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.sum(torch.where(labels[..., None] == ids, logits, 0.0), dim=-1)
    return lse - (reduce_from_model(gold) if cut else gold)


def combine_chunks(m_run: torch.Tensor, s_run: torch.Tensor, gold: torch.Tensor,
                   vocab: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked CE's running (max, sum-exp, gold) of this rank's
    vocabulary block, combined over the model axis where it cuts the
    ``vocab`` ids: ``(lse, gold)``.  Else ``m_run + log(s_run)`` and
    ``gold``."""
    if not vocab_cut(vocab):
        return m_run + torch.log(torch.clamp(s_run, min=1e-30)), gold
    mx = max_over_model(m_run)
    s = reduce_from_model(s_run * torch.exp(m_run - mx))
    return mx + torch.log(torch.clamp(s, min=1e-30)), reduce_from_model(gold)


# ---------------------------------------------------------------------------
# What the model axis does to a config and its leaves
# ---------------------------------------------------------------------------


def check_config(cfg, k: int) -> None:
    """Raise ``ValueError`` naming ``cfg`` and ``k`` unless the model axis of
    ``k`` ranks divides what it cuts: attention and MLA heads, MLP and
    shared-expert columns, experts, Mamba's ``d_inner`` channels, mLSTM and
    sLSTM heads.  A vocabulary it does not divide stays whole."""
    if k == 1:
        return
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
    if "mamba" in cfg.period:
        counts["Mamba channels"] = cfg.mamba.d_inner
    if "mlstm" in cfg.period:
        counts["mLSTM heads"] = cfg.mlstm.n_heads
    if "slstm" in cfg.period:
        counts["sLSTM heads"] = cfg.slstm.n_heads
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


def frames_leaf(name: str) -> bool:
    """A frames frontend's input projection: gathered over the model axis
    for the step, its gradient whole on every rank."""
    return name == "embed_proj"


def partial_leaf(name: str) -> bool:
    """A replicated leaf whose gradient each model rank holds only in part
    (its heads' or channels'): summed over the model axis."""
    return _leaf(name) in ("q_norm", "k_norm", "w_if", "b_i", "b_f", "out_norm", "r", "b")


def head_leaf(name: str, shape) -> bool:
    """An mLSTM per-head projection (H, dh, dh): held as the rank's H / k
    heads (dim 0), where its spec cuts every head's columns."""
    return _leaf(name) in ("wq", "wk", "wv") and len(shape) == 3


def packed_parts(name: str, shape) -> int:
    """The parts a packed matrix's columns hold: 2 for a SwiGLU ``[gate |
    up]`` (the MLP's, the shared experts') and for ``[x | z]`` (Mamba's
    ``w_in``, the mLSTM's ``w_up``), 4 for an sLSTM ``w`` (``[i | f | z |
    o]``); 0 for any other leaf."""
    leaf = _leaf(name)
    if (leaf == "w_in" and len(shape) == 2) or leaf in ("sw_in", "w_up"):
        return 2
    return 4 if leaf == "w" and len(shape) == 2 else 0


def pack_columns(t: torch.Tensor, k: int, parts: int = 2) -> torch.Tensor:
    """A matrix whose last dim packs ``parts`` equal parts, reordered so that
    its ``k`` contiguous blocks are ``[p0_r | p1_r | ...]``, each rank's
    compute block."""
    lead, n = t.shape[:-1], t.shape[-1]
    return t.reshape(*lead, parts, k, n // (parts * k)).transpose(-3, -2).reshape(*lead, n)


def unpack_columns(t: torch.Tensor, k: int, parts: int = 2) -> torch.Tensor:
    """The inverse of :func:`pack_columns`: the one-device layout."""
    lead, n = t.shape[:-1], t.shape[-1]
    return t.reshape(*lead, k, parts, n // (parts * k)).transpose(-3, -2).reshape(*lead, n)


def collectives(cfg, kind: str, rows: int, seq: int, k: int) -> Dict[str, int]:
    """Result bytes of the model axis's activation collectives on one rank
    of ``rows`` sequences of ``seq`` tokens in one step of ``kind``
    (``"train"``, ``"prefill"``, ``"decode"``): one ``g`` a sub-block (under
    remat in training the recompute issues them again, but for a period's
    last: torch's non-reentrant checkpoint stops recomputing after the last
    tensor the backward saved, and a period ends in that ``g`` and the
    residual add); the mixers' two-way sums (Mamba's ``xin @ w_x``, the
    mLSTM's gates and its ``out_norm``'s fp32 sum of squares), forward
    (again under remat) and backward; in training also every ``f``'s
    backward (a sub-block's input; the MLA's latent and rotary key; the
    MoE's gates, fp32).  Where the vocabulary is cut: a token embedding's
    ``g``, in training the unembedding's ``f`` and the CE's three fp32
    reductions a token, in serving the ``all_gather`` of the last
    position's logits.  The leaves' own model-axis collectives (gathered
    leaves, partial ones) are the plan's."""
    out = {"all-reduce": 0, "all-gather": 0}
    if k == 1:
        return out
    b = cfg.torch_dtype().itemsize
    T = rows * (1 if kind == "decode" else seq)
    act = T * cfg.d_model * b
    n = {t: cfg.n_periods * cfg.period.count(t) for t in BLOCKS}
    blocks = cfg.n_periods * len(cfg.period)
    remat = kind == "train" and cfg.remat
    cut = cfg.vocab_size % k == 0
    inner = 0  # the mixers' two-way sums, forward once
    if n["mamba"]:
        dt_rank = cfg.mamba.dt_rank or -(-cfg.d_model // 16)
        inner += n["mamba"] * T * (dt_rank + 2 * cfg.mamba.d_state) * b
    if n["mlstm"]:
        inner += n["mlstm"] * T * (2 * cfg.mlstm.n_heads * b + 4)
    out["all-reduce"] += act * (blocks + (blocks - cfg.n_periods if remat else 0))
    out["all-reduce"] += inner * (2 if remat else 1)
    if cut and cfg.frontend == "tokens":
        out["all-reduce"] += act
    if kind == "train":
        back = act * blocks + inner
        if n["moe"]:
            back += n["moe"] * T * cfg.moe.top_k * 4
        if n["mla"]:
            back += n["mla"] * T * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim) * b
        if cut:
            back += act + 3 * T * 4
        out["all-reduce"] += back
    elif cut:
        out["all-gather"] += rows * cfg.vocab_size * b
    return out
