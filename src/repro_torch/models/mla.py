"""Multi-head Latent Attention (DeepSeek-V2) with a compressed KV cache.

Counterpart of ``src/repro/models/mla.py``.  Keys and values are factored
through a low-rank latent ``c_kv`` (``kv_lora_rank``) plus one rotary key
``k_pe`` (``qk_rope_dim``) shared by every head; only ``(c_kv, k_pe)`` are
cached.  The explicit (non-absorbed) form, as in the JAX package: prefill
expands K and V from the latent and attends through
:func:`repro_torch.kernels.ops.multihead_attention` (the hand-written flash
kernel on the card, at d = nope + rope and dv = v_head_dim), or through
attention's chunked online softmax with ``impl="chunked"``, and each decode
step expands the whole latent cache again and attends in plain PyTorch ops.

Under a model axis (:mod:`repro_torch.runtime.tensor_parallel`) ``wq``,
``w_uk``, ``w_uv`` and ``wo`` hold this rank's ``H / k`` heads; ``w_dkv``
and ``kv_norm`` are replicated, so every rank computes the whole latent.
The latent ``c_kv`` and the rotary key ``k_pe`` feed every rank's heads, so
each goes through ``f`` (their gradients are summed over the axis), as does
the normed input on its way to ``wq``; ``wo``'s output goes through ``g``.
The latent cache is whole on every rank.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..kernels.ref import NEG_INF
from ..runtime import tensor_parallel as tp
from . import layers
from .attention import attend


class MLADims(NamedTuple):
    n_heads: int
    kv_lora_rank: int  # r
    qk_nope_dim: int  # per-head non-rotary q/k dim
    qk_rope_dim: int  # shared rotary dim
    v_head_dim: int
    rope_theta: float
    causal: bool = True
    impl: str = "reference"  # "reference" | "chunked" (attention._chunked_attention)
    chunk: int = 1024
    unroll: bool = False


class MLACache(NamedTuple):
    c_kv: torch.Tensor  # (B, S_max, r)
    k_pe: torch.Tensor  # (B, S_max, qk_rope_dim)


def init_cache(B: int, S_max: int, dims: MLADims, dtype, device) -> MLACache:
    return MLACache(
        c_kv=torch.zeros((B, S_max, dims.kv_lora_rank), dtype=dtype, device=device),
        k_pe=torch.zeros((B, S_max, dims.qk_rope_dim), dtype=dtype, device=device))


class MLA(nn.Module):
    """Pre-norm MLA sub-block: ``x + wo(attend(q(norm(x)), kv(latent(norm(x)))))``.
    Leaves as the reference's: ``norm_scale``, ``wq``, ``w_dkv``,
    ``kv_norm``, ``w_uk``, ``w_uv``, ``wo``."""

    def __init__(self, d_model: int, dims: MLADims, dtype, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        if dims.impl not in ("reference", "chunked"):
            raise ValueError(f"unknown attn_impl {dims.impl!r}")
        self.dims = dims
        H, r = dims.n_heads, dims.kv_lora_rank
        self.norm_scale = layers.param(layers.init_rms_scale(d_model, dtype, device))
        self.wq = layers.dense_param(
            gen, (d_model, H * (dims.qk_nope_dim + dims.qk_rope_dim)), dtype, device)
        self.w_dkv = layers.dense_param(gen, (d_model, r + dims.qk_rope_dim), dtype, device)
        self.kv_norm = layers.param(layers.init_rms_scale(r, dtype, device))
        self.w_uk = layers.dense_param(gen, (r, H * dims.qk_nope_dim), dtype, device)
        self.w_uv = layers.dense_param(gen, (r, H * dims.v_head_dim), dtype, device)
        self.wo = layers.dense_param(gen, (H * dims.v_head_dim, d_model), dtype, device)

    # -- the reference's pieces ---------------------------------------------

    def _latent(self, h: torch.Tensor, positions: torch.Tensor):
        """Compressed KV latent (B, S, r) and rotary key (B, S, rope)."""
        B, S, _ = h.shape
        d = self.dims
        c_kv, k_pe = (h @ self.w_dkv).split([d.kv_lora_rank, d.qk_rope_dim], dim=-1)
        c_kv = layers.rms_norm(c_kv, self.kv_norm)
        k_pe = layers.apply_rope(k_pe.reshape(B, S, 1, d.qk_rope_dim), positions,
                                 d.rope_theta).reshape(B, S, d.qk_rope_dim)
        return c_kv, k_pe

    def _q_heads(self, h: torch.Tensor, positions: torch.Tensor):
        """(q_nope (B, S, H, nope), q_pe (B, S, H, rope) rotated)."""
        B, S, _ = h.shape
        d = self.dims
        q = (h @ self.wq).reshape(B, S, -1, d.qk_nope_dim + d.qk_rope_dim)
        q_nope, q_pe = q.split([d.qk_nope_dim, d.qk_rope_dim], dim=-1)
        return q_nope, layers.apply_rope(q_pe, positions, d.rope_theta)

    def _expand_kv(self, c_kv: torch.Tensor):
        """(k_nope (B, S, H, nope), v (B, S, H, dv)) from the latent."""
        B, S, _ = c_kv.shape
        d = self.dims
        k_nope = (c_kv @ self.w_uk).reshape(B, S, -1, d.qk_nope_dim)
        v = (c_kv @ self.w_uv).reshape(B, S, -1, d.v_head_dim)
        return k_nope, v

    # -- full sequence ---------------------------------------------------------

    def _attend_full(self, x, positions, use_kernel):
        """(output, c_kv, k_pe) over the whole sequence.

        q and k are concatenated (nope | rope) straight into the kernel's
        head-major layout (B, H, S, nope + rope): one copy each, contiguous
        and freshly allocated, so the flash wrapper's 16-byte alignment
        holds without another.  k's rope part is ``k_pe`` broadcast over the
        heads, written once a layer."""
        B, S, _ = x.shape
        d = self.dims
        h = layers.rms_norm(x, self.norm_scale)
        c_kv, k_pe = self._latent(h, positions)
        c_kv, k_pe = tp.copy_to_model(c_kv), tp.copy_to_model(k_pe)
        q_nope, q_pe = self._q_heads(tp.copy_to_model(h), positions)
        k_nope, v = self._expand_kv(c_kv)
        H = q_nope.shape[2]
        q = torch.cat([q_nope.transpose(1, 2), q_pe.transpose(1, 2)], dim=-1)
        k = torch.cat([k_nope.transpose(1, 2),
                       k_pe[:, None].expand(B, H, S, d.qk_rope_dim)], dim=-1)
        out = attend(q, k, v.transpose(1, 2), d, use_kernel)
        out = out.transpose(1, 2).reshape(B, S, H * d.v_head_dim)
        return x + tp.reduce_from_model(out @ self.wo), c_kv, k_pe

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                use_kernel: Optional[bool] = None) -> Tuple[torch.Tensor, None]:
        """Full-sequence MLA (training / prefill).  x: (B, S, d_model).
        Returns (output, None): no aux loss."""
        return self._attend_full(x, positions, use_kernel)[0], None

    def init_cache(self, B: int, S_max: int, dtype, device) -> MLACache:
        return init_cache(B, S_max, self.dims, dtype, device)

    def prefill(self, x: torch.Tensor, positions: torch.Tensor, S_max: int,
                use_kernel: Optional[bool] = None) -> Tuple[torch.Tensor, MLACache]:
        """Forward + latent cache fill (zero-padded to S_max).  The reference
        computes the latent twice (in its forward and again for the cache);
        the same products give the same values, so the port keeps the first."""
        y, c_kv, k_pe = self._attend_full(x, positions, use_kernel)
        B, S, _ = x.shape
        cache = init_cache(B, S_max, self.dims, c_kv.dtype, c_kv.device)
        cache.c_kv[:, :S] = c_kv
        cache.k_pe[:, :S] = k_pe
        return y, cache

    # -- one-token decode ------------------------------------------------------

    def decode_step(self, x: torch.Tensor, cache: MLACache,
                    pos: torch.Tensor) -> Tuple[torch.Tensor, MLACache]:
        """One-token decode; x: (B, 1, d_model), pos: (B,).  Only the latent
        row (r + rope) is appended, in place at ``pos`` (the reference adds it
        through a one-hot over S_max; the slot is still zero, so the cache is
        the same); K and V are expanded again from the whole latent cache,
        and the scores are fp32 with entries past ``pos`` masked."""
        B = x.shape[0]
        d = self.dims
        h = layers.rms_norm(x, self.norm_scale)
        c_new, kpe_new = self._latent(h, pos[:, None])
        rows = torch.arange(B, device=x.device)
        cache.c_kv[rows, pos] = c_new[:, 0]
        cache.k_pe[rows, pos] = kpe_new[:, 0]
        S_max = cache.c_kv.shape[1]
        q_nope, q_pe = self._q_heads(h, pos[:, None])
        k_nope, v = self._expand_kv(cache.c_kv)  # (B, S_max, H, ...)
        H = q_nope.shape[2]
        scores = (torch.einsum("bqhd,bshd->bhqs", q_nope, k_nope)
                  + torch.einsum("bqhd,bsd->bhqs", q_pe, cache.k_pe)).float()
        scores = scores / ((d.qk_nope_dim + d.qk_rope_dim) ** 0.5)
        valid = torch.arange(S_max, device=x.device)[None, :] <= pos[:, None]
        scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqs,bshd->bqhd", probs.to(v.dtype), v)
        out = out.reshape(B, 1, H * d.v_head_dim)
        return x + tp.reduce_from_model(out @ self.wo), cache
