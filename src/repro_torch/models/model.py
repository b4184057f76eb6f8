"""Config-driven LM stack: every architecture of the JAX registry, periods
of ``attn``, ``mla``, ``mlp``, ``moe``, ``mamba``, ``mlstm`` and ``slstm``
sub-blocks over a token or a frames frontend.

Counterpart of ``src/repro/models/model.py``.  :class:`ModelConfig` carries
the same fields as the JAX package's, so the config modules copy over
unchanged; :class:`Transformer` holds one module per sub-block
(``n_periods * len(period)`` of them, in order) where the JAX package stacks
each period position over a scan axis, and
:func:`repro_torch.convert.lm_params_from_reference` unstacks one into the
other.

Inputs are the reference's batch keys: token ids (B, S) for a ``tokens``
frontend, or precomputed frames (B, S, d_model) for ``frames`` (an encoder:
HuBERT), cast to the model's type and projected by ``embed_proj``.  An
encoder has no serving path (``prefill`` and ``decode_step`` raise).  After
an SSM block ``prefill`` returns a fresh state, as the reference's does.

Training: :func:`loss_fn` (the next-token cross-entropy for causal token
models, the frame-label cross-entropy for encoders, plain or chunked over
the vocabulary) and :func:`make_train_step`.  With ``cfg.remat`` each
period is a checkpointed region of ``forward``: ``remat_policy="full"``
recomputes all of it in the backward, ``"dots"`` saves the weight products'
outputs (the counterpart of ``dots_with_no_batch_dims_saveable``) and
recomputes the rest.  The serving paths (``prefill``, ``decode_step``) run
under ``torch.no_grad()``.

``unroll_scan`` (the reference's cost-extraction mode) changes nothing in
eager PyTorch, where nothing is traced, except on an sLSTM block: there it
swaps in the reference's FLOP-equivalent parallel form, the dry run's cost
proxy (:class:`repro_torch.models.ssm.SLSTM`).

The dry run's pieces: :func:`abstract_params` and :func:`abstract_cache`
build on the ``meta`` device (shapes and types, no storage), and the
sharding rules -- :func:`param_specs`, :func:`batch_specs`,
:func:`cache_specs` -- give the reference's spec for every leaf, a spec
being a tuple of ``None | axis | tuple of axes``.  ``forward`` pins the
batch axes before every block (:mod:`.hints`), as the reference does.

Under a model axis (:mod:`repro_torch.runtime.tensor_parallel`; a driver
enters ``hints.use_model_shards`` and hands the model its blocks) every
sub-block is column- then row-parallel (the SSM mixers over their channels
or heads, :mod:`.ssm`), and where the axis divides the vocabulary the
embedding and the unembedding are vocabulary-parallel (``embed``'s rows, an
untied ``head``'s columns), the logits a rank returns are its vocabulary
block, and the cross-entropy, plain or chunked, reduces over the axis.  A
vocabulary it does not divide stays whole on every rank, as do the logits
and the cross-entropy.  A frames frontend's ``embed_proj`` is whole for the
step (the plan gathers it), so the residual stream starts whole.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from ..runtime import tensor_parallel as tp
from . import attention, hints, layers, mla, moe, ssm


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | audio | vlm | hybrid
    n_periods: int
    period: Tuple[str, ...]  # sub-block types applied in order, per period
    d_model: int
    vocab_size: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    causal: bool = True
    mrope_sections: Optional[Tuple[int, int, int]] = None
    # dense mlp
    d_ff: int = 0
    # family-specific dims
    moe: Optional[moe.MoEDims] = None
    mla: Optional[mla.MLADims] = None
    mamba: Optional[ssm.MambaDims] = None
    mlstm: Optional[ssm.MLSTMDims] = None
    slstm: Optional[ssm.SLSTMDims] = None
    # io
    frontend: str = "tokens"  # tokens | frames (precomputed embeddings stub)
    tie_embeddings: bool = False
    # numerics / scaling
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"
    ssm_chunk: int = 256
    ce_impl: str = "plain"
    ce_chunk: int = 8192
    attn_impl: str = "reference"
    attn_chunk: int = 1024
    unroll_scan: bool = False
    # capability flags
    supports_decode: bool = True
    sub_quadratic: bool = False

    @property
    def n_layers(self) -> int:
        return self.n_periods * len(self.period)

    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def attn_dims(self) -> attention.AttnDims:
        return attention.AttnDims(
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            d_head=self.d_head,
            qk_norm=self.qk_norm,
            qkv_bias=self.qkv_bias,
            rope_theta=self.rope_theta,
            causal=self.causal,
            mrope_sections=self.mrope_sections,
            impl=self.attn_impl,
            chunk=self.attn_chunk,
            unroll=self.unroll_scan,
        )


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a frontend the reference does not know (an unknown block
    type raises in :func:`_block`, an unknown ``attn_impl`` in the
    attention blocks)."""
    if cfg.frontend not in ("tokens", "frames"):
        raise ValueError(f"unknown frontend {cfg.frontend!r}")


def _check_decodes(cfg: ModelConfig) -> None:
    """Raise for an encoder-only config (frames in, no decode path)."""
    if cfg.frontend != "tokens" or not cfg.supports_decode:
        raise ValueError(f"{cfg.name}: encoder-only arch has no prefill or decode step")


class MLP(layers.Stateless, nn.Module):
    """Pre-norm SwiGLU sub-block: ``x + swiglu(norm(x))``; under a model
    axis ``w_in`` holds this rank's ``[gate_r | up_r]`` columns and
    ``w_out`` its rows, between ``f`` and ``g``."""

    def __init__(self, d_model: int, d_ff: int, dtype, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.norm_scale = layers.param(layers.init_rms_scale(d_model, dtype, device))
        self.w_in = layers.dense_param(gen, (d_model, 2 * d_ff), dtype, device)
        self.w_out = layers.dense_param(gen, (d_ff, d_model), dtype, device)

    def forward(self, x: torch.Tensor, positions: Optional[torch.Tensor] = None,
                use_kernel: Optional[bool] = None) -> Tuple[torch.Tensor, None]:
        h = tp.copy_to_model(layers.rms_norm(x, self.norm_scale))
        return x + tp.reduce_from_model(layers.swiglu(h, self.w_in, self.w_out)), None


# one entry per sub-block: a KV cache (attn), a latent cache (mla), a
# recurrent state (mamba, mlstm, slstm), or None (mlp, moe)
Cache = List[Optional[Union[attention.KVCache, mla.MLACache, ssm.MambaState,
                            ssm.MLSTMState, ssm.SLSTMState]]]


class Transformer(nn.Module):
    """The LM.  ``seed`` draws random weights on ``device`` with a
    generator of that device, sub-block by sub-block; ``seed=None`` leaves
    them uninitialized for :meth:`load_params`, as does ``device="meta"``
    (:func:`abstract_params`).  A ``frames`` config holds
    ``embed_proj`` (d_model, d_model) in place of ``embed``.

    Every sub-block has one interface: ``forward(x, positions, use_kernel)
    -> (x, aux or None)`` (only MoE has an aux loss), ``init_cache(B, S_max,
    dtype, device)``, ``prefill(x, positions, S_max, use_kernel) -> (x,
    cache)`` and ``decode_step(x, cache, pos) -> (x, cache)``; the blocks
    without a cache take the last three from :class:`layers.Stateless`."""

    def __init__(self, cfg: ModelConfig, *, device, seed: Optional[int] = 0):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        dtype = cfg.torch_dtype()
        device = torch.device(device)
        # meta holds no values, so nothing is drawn there
        gen = (None if seed is None or device.type == "meta"
               else torch.Generator(device=device).manual_seed(seed))
        if cfg.frontend == "tokens":
            embed_shape = (cfg.vocab_size, cfg.d_model)
            self.embed = layers.param(
                torch.empty(embed_shape, dtype=dtype, device=device) if gen is None
                else layers.embed_init(gen, embed_shape, dtype, device))
        else:  # frames: precomputed embeddings -> a learned input projection
            self.embed_proj = layers.dense_param(gen, (cfg.d_model, cfg.d_model), dtype,
                                                 device)
        self.blocks = nn.ModuleList(
            _block(btype, cfg, dtype, device, gen)
            for _ in range(cfg.n_periods) for btype in cfg.period)
        self.final_norm = layers.param(layers.init_rms_scale(cfg.d_model, dtype, device))
        if not cfg.tie_embeddings:
            self.head = layers.dense_param(gen, (cfg.d_model, cfg.vocab_size), dtype, device)
        # (period i, its input) -> ({block index: {name: tensor}}, its input):
        # what period i's blocks compute with in place of those parameters (a
        # sharded train step's per-period gathers, runtime/data_parallel.py)
        self.period_params: Optional[Callable] = None

    @classmethod
    def from_params(cls, cfg: ModelConfig, params: Dict[str, Any], *, device):
        """A model holding ``params`` (a state dict, e.g. from
        :func:`repro_torch.convert.lm_params_from_reference`)."""
        model = cls(cfg, device=device, seed=None)
        model.load_params(params)
        return model

    @torch.no_grad()
    def load_params(self, params: Dict[str, Any]) -> None:
        own = self.state_dict(keep_vars=True)
        if set(own) != set(params):
            raise KeyError(f"parameter names differ: missing "
                           f"{sorted(set(own) - set(params))[:5]}, unexpected "
                           f"{sorted(set(params) - set(own))[:5]}")
        for name, p in own.items():
            src = torch.as_tensor(params[name])
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)}, expected {tuple(p.shape)}")
            p.copy_(src.to(dtype=p.dtype))

    # -- pieces --------------------------------------------------------------

    def _positions(self, B: int, S: int, device) -> torch.Tensor:
        return torch.arange(S, device=device)[None].expand(B, S)

    def _embed(self, inputs) -> torch.Tensor:
        """(B, S, d_model) from token ids (B, S) or frames (B, S, d_model),
        or from a batch of the reference's keys (``tokens`` or ``frames``)."""
        if isinstance(inputs, Mapping):
            inputs = inputs["tokens" if self.cfg.frontend == "tokens" else "frames"]
        if self.cfg.frontend == "tokens":
            return tp.embed_lookup(self.embed, inputs, self.cfg.vocab_size)
        return inputs.to(self.embed_proj.dtype) @ self.embed_proj

    def _unembed(self, x: torch.Tensor) -> torch.Tensor:
        x = _head_input(x, self.final_norm, self.cfg.vocab_size)
        if self.cfg.tie_embeddings:
            return x @ self.embed.T
        return x @ self.head

    # -- step functions ------------------------------------------------------

    def _period(self, i: int, x: torch.Tensor, aux: torch.Tensor, positions: torch.Tensor,
                use_kernel: Optional[bool]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Period ``i`` on ``x``, the MoE aux losses added to ``aux`` in
        block order (the reference's scan carries ``(x, aux)``).  With
        ``period_params`` set, its tensors are taken first (in a remat
        recompute again) and the blocks run on them."""
        P = len(self.cfg.period)
        swap = {}
        if self.period_params is not None:
            swap, x = self.period_params(i, x)
        for j in range(i * P, (i + 1) * P):
            x = hints.constrain_batch(x)  # re-pin the batch axes every block
            if j in swap:
                x, a = torch.func.functional_call(self.blocks[j], swap[j],
                                                  (x, positions, use_kernel))
            else:
                x, a = self.blocks[j](x, positions, use_kernel)
            if a is not None:
                aux = aux + a
        return x, aux

    def hidden(self, inputs, use_kernel: Optional[bool] = None,
               cfg: Optional[ModelConfig] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The last period's output (B, S, d_model), before the final norm,
        and the summed MoE aux loss (fp32; 0 without MoE blocks).
        ``inputs``: token ids, frames, or a batch dict (:meth:`_embed`).
        ``cfg`` (default ``self.cfg``) supplies ``remat`` and
        ``remat_policy``; remat applies only while autograd records.  A
        period's ``period_params`` are taken inside the checkpointed region,
        so its recompute takes them again; with remat off autograd keeps
        them for the backward (every period's)."""
        cfg = cfg or self.cfg
        if tp.active() is not None:
            tp.check_config(self.cfg, tp.active().ranks)
        x = self._embed(inputs)
        B, S, _ = x.shape
        positions = self._positions(B, S, x.device)
        remat = cfg.remat and torch.is_grad_enabled()
        policy_fn = _ckpt.noop_context_fn
        if remat and cfg.remat_policy == "dots":
            policy_fn = functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                          _save_dots)
        elif remat and cfg.remat_policy != "full":
            raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")

        def context_fn():  # the recompute keeps the forward's mesh and token split
            forward_ctx, recompute_ctx = policy_fn()
            return forward_ctx, hints.recompute_context(recompute_ctx)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.n_periods):
            if remat:
                x, aux = _ckpt.checkpoint(self._period, i, x, aux, positions, use_kernel,
                                          use_reentrant=False, context_fn=context_fn)
            else:
                x, aux = self._period(i, x, aux, positions, use_kernel)
        return x, aux

    def forward(self, inputs, use_kernel: Optional[bool] = None,
                cfg: Optional[ModelConfig] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence logits (B, S, V) and the summed MoE aux loss."""
        x, aux = self.hidden(inputs, use_kernel, cfg)
        return self._unembed(x), aux

    def init_cache(self, B: int, S_max: int) -> Cache:
        """Empty caches and fresh recurrent states, one a sub-block."""
        _check_decodes(self.cfg)
        dtype, device = self.final_norm.dtype, self.final_norm.device
        return [blk.init_cache(B, S_max, dtype, device) for blk in self.blocks]

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, S_max: int,
                use_kernel: Optional[bool] = None) -> Tuple[torch.Tensor, Cache]:
        """Forward over the prompt, filling the caches: (last logits (B, 1, V),
        cache).  An SSM block's entry is a fresh state, not the state at the
        prompt's end (the reference's documented serving limitation)."""
        _check_decodes(self.cfg)
        return self.prefill_inputs(tokens, S_max, use_kernel)

    @torch.no_grad()
    def prefill_inputs(self, inputs, S_max: int,
                       use_kernel: Optional[bool] = None) -> Tuple[torch.Tensor, Cache]:
        """:meth:`prefill` on anything :meth:`_embed` takes, an encoder's
        frames included: the reference's ``prefill``, which has no encoder
        check (the dry run's ``prefill_32k`` cell of HuBERT)."""
        x = self._embed(inputs)
        B, S, _ = x.shape
        positions = self._positions(B, S, x.device)
        cache: Cache = []
        for blk in self.blocks:
            x, c = blk.prefill(x, positions, S_max, use_kernel)
            cache.append(c)
        return self._unembed(x[:, -1:, :]), cache

    @torch.no_grad()
    def decode_step(self, cache: Cache, token: torch.Tensor,
                    pos: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """One decode step.  token, pos: (B,).  Returns (logits (B, 1, V),
        cache); the cache is updated in place.  A MoE block routes the B new
        tokens as one batch (T = B, its capacity from that), as the
        reference does.  A recurrent block's state advances in place."""
        _check_decodes(self.cfg)
        x = self._embed(token[:, None])
        for blk, c in zip(self.blocks, cache):
            x, _ = blk.decode_step(x, c, pos)
        return self._unembed(x), cache


def _head_input(x: torch.Tensor, final_norm: torch.Tensor, vocab: int) -> torch.Tensor:
    """The unembedding's input: the final norm, through ``f`` where the
    model axis cuts the vocabulary (a whole head's gradient is whole on
    every rank)."""
    x = layers.rms_norm(x, final_norm)
    return tp.copy_to_model(x) if tp.vocab_cut(vocab) else x


def _block(btype: str, cfg: ModelConfig, dtype, device, gen) -> nn.Module:
    d = cfg.d_model
    if btype == "attn":
        return attention.Attention(d, cfg.attn_dims(), dtype, device, gen)
    if btype == "mla":
        return mla.MLA(d, _mla_dims(cfg), dtype, device, gen)
    if btype == "mlp":
        return MLP(d, cfg.d_ff, dtype, device, gen)
    if btype == "moe":
        return moe.MoE(d, cfg.moe, dtype, device, gen)
    if btype == "mamba":
        return ssm.Mamba(d, cfg.mamba, cfg.ssm_chunk, dtype, device, gen)
    if btype == "mlstm":
        return ssm.MLSTM(d, cfg.mlstm, cfg.ssm_chunk, dtype, device, gen)
    if btype == "slstm":
        return ssm.SLSTM(d, cfg.slstm, dtype, device, gen, cost_mode=cfg.unroll_scan)
    raise ValueError(f"unknown block type {btype!r}")


def _mla_dims(cfg: ModelConfig) -> mla.MLADims:
    """The MLA dims a full-sequence pass uses: the config's attention
    implementation options, as the reference's ``_apply_block`` sets them."""
    return cfg.mla._replace(impl=cfg.attn_impl, chunk=cfg.attn_chunk,
                            unroll=cfg.unroll_scan)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective checkpointing's policy for ``remat_policy="dots"``: keep the
    outputs of products without a batch dimension (the weight products,
    ``aten.mm``/``addmm``), recompute everything else (attention's batched
    products included), as ``dots_with_no_batch_dims_saveable`` does."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


# ---------------------------------------------------------------------------
# Loss / train step
# ---------------------------------------------------------------------------


def loss_fn(model: Transformer, batch: Dict[str, torch.Tensor],
            cfg: Optional[ModelConfig] = None, *,
            use_kernel: Optional[bool] = None) -> torch.Tensor:
    """The cross-entropy, a scalar fp32 tensor.  A causal token model: next
    token of ``batch["tokens"]`` (B, S + 1), inputs ``tokens[:, :-1]``,
    labels ``tokens[:, 1:]``.  An encoder (non-causal or frames): the batch
    without ``labels`` as inputs, ``batch["labels"]`` (B, S) as labels, no
    shift.

    ``cfg`` (default ``model.cfg``) supplies the numerics options --
    ``ce_impl``, ``ce_chunk``, ``remat``, ``remat_policy`` -- as the JAX
    package's ``cfg`` argument does.  The plain CE is written as the JAX
    package writes it, as reductions over the vocabulary: the max (without
    gradient), the sum of exponentials and the one-hot sum of the gold
    logits (``tensor_parallel.cross_entropy``, over the model axis where
    there is one).
    """
    cfg = cfg or model.cfg
    if cfg.causal and cfg.frontend == "tokens":
        inputs, labels = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    else:
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        labels = batch["labels"]
    if cfg.ce_impl == "chunked":
        return _chunked_ce(model, inputs, labels, cfg, use_kernel)
    if cfg.ce_impl != "plain":
        raise ValueError(f"unknown ce_impl {cfg.ce_impl!r}")
    logits, aux = model(inputs, use_kernel, cfg)
    return torch.mean(tp.cross_entropy(logits.float(), labels, cfg.vocab_size)) + aux


def _ce_chunk(m_run, s_run, gold, x, head_c, labels, start: int):
    """One vocabulary chunk of :func:`_chunked_ce`: the running max, sum of
    exponentials and gold logit after the chunk's logits."""
    logit_c = (x @ head_c).float()  # (B, S, ck)
    m_new = torch.maximum(m_run, torch.amax(logit_c, dim=-1))
    s_run = s_run * torch.exp(m_run - m_new) + torch.sum(
        torch.exp(logit_c - m_new[..., None]), dim=-1)
    ids = start + torch.arange(head_c.shape[1], device=x.device)
    hit = labels[..., None] == ids
    gold = gold + torch.sum(torch.where(hit, logit_c, 0.0), dim=-1)
    return m_new, s_run, gold


def _chunked_ce(model: Transformer, inputs, labels, cfg: ModelConfig, use_kernel):
    """Cross-entropy without a (B, S, V) logits tensor: the unembedding is
    streamed over ``cfg.ce_chunk``-column slices of the head, carrying the
    running (max, sum-exp, gold) as the JAX package's scan does.  Each
    chunk is a checkpointed region, so the backward recomputes its logits
    instead of keeping them: (B, S, ce_chunk) live at a time either way.

    The JAX package pads the head to a multiple of the chunk and masks the
    padded logits with -1e30; the port's last chunk is a shorter slice,
    which adds the same exact zeros to the running sum.  Under a model axis
    that cuts the vocabulary the chunks run over this rank's block, and the
    running triple is combined over the axis once
    (``tensor_parallel.combine_chunks``).
    """
    x, aux = model.hidden(inputs, use_kernel, cfg)
    x = _head_input(x, model.final_norm, cfg.vocab_size)
    head = model.embed.T if cfg.tie_embeddings else model.head  # (d, V)
    B, S, _ = x.shape
    m_run = torch.full((B, S), -1e30, dtype=torch.float32, device=x.device)
    s_run = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    gold = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    # the vocabulary block's first id
    first = tp.vocab_start(head.shape[1]) if tp.vocab_cut(cfg.vocab_size) else 0
    for start in range(0, head.shape[1], cfg.ce_chunk):
        head_c = head[:, start:start + cfg.ce_chunk]
        if torch.is_grad_enabled():
            m_run, s_run, gold = _ckpt.checkpoint(
                _ce_chunk, m_run, s_run, gold, x, head_c, labels, first + start,
                use_reentrant=False)
        else:
            m_run, s_run, gold = _ce_chunk(m_run, s_run, gold, x, head_c, labels,
                                           first + start)
    lse, gold = tp.combine_chunks(m_run, s_run, gold, cfg.vocab_size)
    return torch.mean(lse - gold) + aux


def loss_and_grads(model: Transformer, batch: Dict[str, torch.Tensor], *,
                   use_kernel: Optional[bool] = None,
                   wrt: Optional[Dict[str, torch.Tensor]] = None):
    """``(loss, grads)``: the loss of ``batch`` and every parameter's
    gradient by name (``torch.autograd.grad``; nothing is left in
    ``.grad``), or the gradient of each tensor of ``wrt`` (name -> tensor).
    The body of every train step, on one device or a rank."""
    params = dict(model.named_parameters()) if wrt is None else wrt
    loss = loss_fn(model, batch, use_kernel=use_kernel)
    return loss, dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


def make_train_step(optimizer, *, use_kernel: Optional[bool] = None) -> Callable:
    """``train_step(model, opt_state, batch) -> (loss, opt_state)``:
    :func:`loss_and_grads`, then ``optimizer.update``, which writes the new
    parameters into the model in place.  ``loss`` is a detached scalar
    tensor on the model's device."""

    def train_step(model: Transformer, opt_state, batch: Dict[str, torch.Tensor]):
        loss, grads = loss_and_grads(model, batch, use_kernel=use_kernel)
        _, opt_state = optimizer.update(dict(model.named_parameters()), grads, opt_state)
        return loss.detach(), opt_state

    return train_step


# ---------------------------------------------------------------------------
# The dry run's abstract build (meta device: shapes and types, no storage)
# ---------------------------------------------------------------------------


def abstract_params(cfg: ModelConfig, seed: int = 0) -> Transformer:
    """The model on the ``meta`` device: every parameter with its shape and
    type and no storage (the reference's ``ShapeDtypeStruct`` pytree).
    ``seed`` is the reference's argument; nothing is drawn on meta."""
    return Transformer(cfg, device="meta", seed=None)


def abstract_cache(cfg: ModelConfig, B: int, S_max: int) -> Cache:
    """The serving cache of :meth:`Transformer.init_cache` on ``meta``, one
    entry a sub-block, for any frontend (the reference's ``init_cache`` has
    no encoder check)."""
    model = abstract_params(cfg)
    dtype = cfg.torch_dtype()
    return [blk.init_cache(B, S_max, dtype, "meta") for blk in model.blocks]


# ---------------------------------------------------------------------------
# Sharding rules (the reference's baseline FSDP x TP plan)
# ---------------------------------------------------------------------------

Spec = Tuple[Any, ...]  # one entry a dimension: None | axis | tuple of axes

# leaf name -> spec of the block-local shape
_RULES: Dict[str, Spec] = {
    # attention
    "wq": ("data", "model"),
    "wk": ("data", "model"),
    "wv": ("data", "model"),
    "wo": ("model", "data"),
    "bq": ("model",),
    "bk": ("model",),
    "bv": ("model",),
    # mlp
    "w_in": ("data", "model"),
    "w_out": ("model", "data"),
    # moe (expert-major weights override w_in/w_out by rank below)
    "router": ("data", None),
    "sw_in": ("data", "model"),
    "sw_out": ("model", "data"),
    # mla
    "w_dkv": ("data", None),
    "w_uk": (None, "model"),
    "w_uv": (None, "model"),
    # mamba
    "conv_w": (None, "model"),
    "conv_b": ("model",),
    "w_x": ("model", None),
    "w_dt": (None, "model"),
    "dt_bias": ("model",),
    "A_log": ("model", None),
    "D": ("model",),
    # mlstm / slstm
    "w_up": ("data", "model"),
    "w_if": ("data", None),
    "b_i": (None,),
    "b_f": (None,),
    "w_down": ("model", "data"),
    "w": ("data", "model"),
    "r": (None,),
    "b": (None,),
    # io
    "embed": ("model", "data"),
    "embed_proj": ("data", "model"),
    "head": ("data", "model"),
}

_REPLICATED = {"norm_scale", "q_norm", "k_norm", "kv_norm", "out_norm", "final_norm"}


def _spec_for(name: str, rank: int) -> Spec:
    """The reference's rule for the leaf ``name`` (a parameter name of
    :class:`Transformer`) of block-local rank ``rank``."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in _REPLICATED:
        return ()
    if leaf in ("w_in", "w_out") and rank == 3:  # MoE expert stacks
        return ("model", "data", None) if leaf == "w_in" else ("model", None, "data")
    if leaf in ("wq", "wk", "wv") and rank == 3:  # mLSTM per-head (H, dh, dh)
        return (None, "data", "model")
    if leaf in _RULES:
        return _RULES[leaf][:rank]  # trim over-long specs for low-rank leaves
    return ()


def _entry_size(sizes: Mapping[str, int], entry) -> int:
    axes = entry if isinstance(entry, tuple) else (entry,)
    n = 1
    for a in axes:
        n *= int(sizes[a])
    return n


def fit_spec(spec: Spec, shape, sizes: Mapping[str, int]) -> Spec:
    """The divisibility fix: an entry whose mesh size does not divide its
    dimension becomes None (a 504-class head over a 16-way model axis)."""
    return tuple(None if e is None or shape[dim] % _entry_size(sizes, e) else e
                 for dim, e in enumerate(spec))


def _leaves(params_like) -> Dict[str, Any]:
    if isinstance(params_like, nn.Module):
        return dict(params_like.state_dict(keep_vars=True))
    return dict(params_like)


def param_specs(cfg: ModelConfig, params_like, mesh=None) -> Dict[str, Spec]:
    """The reference's spec for every parameter, keyed by the port's names
    (``blocks.{i}.{leaf}``, as :func:`repro_torch.convert.lm_params_from_reference`
    keys the reference's leaves).  ``params_like``: a :class:`Transformer`
    (on meta, for instance) or a dict of name -> tensor.  A block's spec is
    the reference's without its leading period axis (``None`` there).

    With ``mesh`` given, axes that do not divide the corresponding dimension
    are dropped, as the reference's explicit input shardings require."""
    leaves = _leaves(params_like)
    specs = {k: _spec_for(k, len(v.shape)) for k, v in leaves.items()}
    if mesh is None:
        return specs
    sizes = hints.mesh_axis_sizes(mesh)
    return {k: fit_spec(spec, leaves[k].shape, sizes) for k, spec in specs.items()}


def batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in hints.mesh_axis_sizes(mesh) else ("data",)


def _mesh_size(mesh, axes: Tuple[str, ...]) -> int:
    sizes = hints.mesh_axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _batch_spec_entry(mesh, size: int):
    """Largest suffix of the batch axes whose size divides ``size``: the
    pod axis is dropped first, then data (a spec entry, or None)."""
    ba = batch_axes(mesh)
    for start in range(len(ba)):
        axes = ba[start:]
        if size % _mesh_size(mesh, axes) == 0:
            return axes if len(axes) > 1 else axes[0]
    return None


def batch_specs(cfg: ModelConfig, mesh, kind: str, global_batch: int) -> Dict[str, Spec]:
    """Input specs of a step kind ('train' | 'prefill' | 'decode').  A batch
    the data axes do not divide is replicated (the long_500k cell's one
    request)."""
    b = _batch_spec_entry(mesh, global_batch)
    if kind == "decode":
        return {"token": (b,), "pos": (b,)}
    if cfg.frontend == "tokens":
        return {"tokens": (b, None)}
    out = {"frames": (b, None, None)}
    if kind == "train":
        out["labels"] = (b, None)
    return out


def cache_specs(cfg: ModelConfig, cache_like: Cache, mesh) -> List[Any]:
    """The cache's specs, one entry a sub-block as in ``cache_like`` (a
    NamedTuple of specs, or None): the batch dim over the data axes where
    they divide it, the rest left unconstrained.  The reference's leaves
    carry a leading period axis (``None`` in its spec) that the port's
    per-block caches do not."""

    def spec(leaf) -> Spec:
        return (_batch_spec_entry(mesh, int(leaf.shape[0])),) + (None,) * (leaf.dim() - 1)

    return [None if c is None else type(c)(*(spec(t) for t in c)) for c in cache_like]
