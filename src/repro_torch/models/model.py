"""Config-driven LM stack, dense family: ``("attn", "mlp")`` periods.

Counterpart of the dense part of ``src/repro/models/model.py``.
:class:`ModelConfig` carries the same fields as the JAX package's, so the
config modules copy over unchanged; :class:`Transformer` holds one module per
sub-block (``n_periods * len(period)`` of them, in order) where the JAX
package stacks each period position over a scan axis, and
:func:`repro_torch.convert.lm_params_from_reference` unstacks one into the
other.  Block types, frontends and options of other families raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from . import attention, layers

# what is not ported yet, and the ROADMAP queue 1 item that ports it
_UNPORTED_BLOCKS = {
    "mla": "14c (MLA/MoE)",
    "moe": "14c (MLA/MoE)",
    "mamba": "14d (SSM)",
    "mlstm": "14d (SSM)",
    "slstm": "14d (SSM)",
}


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
    # family-specific dims (not ported: ROADMAP queue 1 items 14c, 14d)
    moe: Optional[Any] = None
    mla: Optional[Any] = None
    mamba: Optional[Any] = None
    mlstm: Optional[Any] = None
    slstm: Optional[Any] = None
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
    """Raise ``NotImplementedError`` for what this slice does not cover."""
    for btype in cfg.period:
        if btype in _UNPORTED_BLOCKS:
            raise NotImplementedError(
                f"{cfg.name}: block type {btype!r} is ROADMAP queue 1 item "
                f"{_UNPORTED_BLOCKS[btype]}")
        if btype not in ("attn", "mlp"):
            raise ValueError(f"unknown block type {btype!r}")
    if cfg.frontend != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: frontend={cfg.frontend!r} (hubert) is ROADMAP queue 1 item 14e")
    # M-RoPE and attn_impl="chunked" raise in attention.Attention


class MLP(nn.Module):
    """Pre-norm SwiGLU sub-block: ``x + swiglu(norm(x))``."""

    def __init__(self, d_model: int, d_ff: int, dtype, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.norm_scale = layers.param(layers.init_rms_scale(d_model, dtype, device))
        self.w_in = layers.dense_param(gen, (d_model, 2 * d_ff), dtype, device)
        self.w_out = layers.dense_param(gen, (d_ff, d_model), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = layers.rms_norm(x, self.norm_scale)
        return x + layers.swiglu(h, self.w_in, self.w_out)


Cache = List[Optional[attention.KVCache]]  # one entry per sub-block


class Transformer(nn.Module):
    """The dense LM.  ``seed`` draws random weights on ``device`` with a
    generator of that device, sub-block by sub-block; ``seed=None`` leaves
    them uninitialized for :meth:`load_params`."""

    def __init__(self, cfg: ModelConfig, *, device, seed: Optional[int] = 0):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        dtype = cfg.torch_dtype()
        device = torch.device(device)
        gen = None if seed is None else torch.Generator(device=device).manual_seed(seed)
        embed_shape = (cfg.vocab_size, cfg.d_model)
        self.embed = layers.param(
            torch.empty(embed_shape, dtype=dtype, device=device) if gen is None
            else layers.embed_init(gen, embed_shape, dtype, device))
        blocks = []
        for _ in range(cfg.n_periods):
            for btype in cfg.period:
                if btype == "attn":
                    blocks.append(attention.Attention(
                        cfg.d_model, cfg.attn_dims(), dtype, device, gen))
                else:
                    blocks.append(MLP(cfg.d_model, cfg.d_ff, dtype, device, gen))
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = layers.param(layers.init_rms_scale(cfg.d_model, dtype, device))
        if not cfg.tie_embeddings:
            self.head = layers.dense_param(gen, (cfg.d_model, cfg.vocab_size), dtype, device)

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

    def _unembed(self, x: torch.Tensor) -> torch.Tensor:
        x = layers.rms_norm(x, self.final_norm)
        if self.cfg.tie_embeddings:
            return x @ self.embed.T
        return x @ self.head

    # -- step functions ------------------------------------------------------

    def forward(self, tokens: torch.Tensor,
                use_kernel: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence logits (B, S, V) and the MoE aux loss (0 here)."""
        x = self.embed[tokens]
        B, S, _ = x.shape
        positions = self._positions(B, S, x.device)
        for blk in self.blocks:
            if isinstance(blk, attention.Attention):
                x = blk(x, positions, use_kernel)
            else:
                x = blk(x)
        return self._unembed(x), torch.zeros((), dtype=torch.float32, device=x.device)

    def init_cache(self, B: int, S_max: int) -> Cache:
        return [attention.init_cache(B, S_max, blk.dims, self.embed.dtype, self.embed.device)
                if isinstance(blk, attention.Attention) else None
                for blk in self.blocks]

    def prefill(self, tokens: torch.Tensor, S_max: int,
                use_kernel: Optional[bool] = None) -> Tuple[torch.Tensor, Cache]:
        """Forward over the prompt, filling the caches: (last logits (B, 1, V),
        cache)."""
        x = self.embed[tokens]
        B, S, _ = x.shape
        positions = self._positions(B, S, x.device)
        cache: Cache = []
        for blk in self.blocks:
            if isinstance(blk, attention.Attention):
                x, c = blk.prefill(x, positions, S_max, use_kernel)
            else:
                x, c = blk(x), None
            cache.append(c)
        return self._unembed(x[:, -1:, :]), cache

    def decode_step(self, cache: Cache, token: torch.Tensor,
                    pos: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """One decode step.  token, pos: (B,).  Returns (logits (B, 1, V),
        cache); the cache is updated in place."""
        x = self.embed[token[:, None]]
        for blk, c in zip(self.blocks, cache):
            if isinstance(blk, attention.Attention):
                x, _ = blk.decode_step(x, c, pos)
            else:
                x = blk(x)
        return self._unembed(x), cache
