"""GQA attention block (qk-norm / QKV-bias variants) with a KV cache.

Counterpart of ``src/repro/models/attention.py``.  The full-sequence paths
(``forward``, ``prefill``) attend through
:func:`repro_torch.kernels.ops.multihead_attention`: the hand-written flash
kernel on the card, the plain version on the CPU.  Decode is dense one-token
attention over the cache in plain PyTorch ops, as in the JAX package (it
reads the whole cache once and is bound by that read).  Weights keep the JAX
layout, ``(in, out)``, so ``x @ w``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..kernels import ops
from ..kernels.ref import NEG_INF
from . import layers


class AttnDims(NamedTuple):
    n_heads: int
    n_kv_heads: int
    d_head: int
    qk_norm: bool
    qkv_bias: bool
    rope_theta: float
    causal: bool
    mrope_sections: Optional[Tuple[int, int, int]] = None  # M-RoPE if set
    impl: str = "reference"  # "reference" | "chunked" (flash-in-XLA)
    chunk: int = 1024
    unroll: bool = False  # cost-extraction: unroll the kv-chunk scan


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, Hkv, dh)
    v: torch.Tensor  # (B, S_max, Hkv, dh)


def init_cache(B: int, S_max: int, dims: AttnDims, dtype, device) -> KVCache:
    shape = (B, S_max, dims.n_kv_heads, dims.d_head)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


class Attention(nn.Module):
    """Pre-norm attention sub-block: ``x + wo(attend(rope(qkv(norm(x)))))``."""

    def __init__(self, d_model: int, dims: AttnDims, dtype, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        if dims.mrope_sections is not None:
            raise NotImplementedError("M-RoPE (qwen2-vl) is ROADMAP queue 1 item 14f")
        if dims.impl != "reference":
            raise NotImplementedError(
                f"attn_impl={dims.impl!r}: the port attends through its flash kernel "
                "only (ROADMAP queue 1 item 14h)")
        self.dims = dims
        H, Hkv, dh = dims.n_heads, dims.n_kv_heads, dims.d_head
        self.norm_scale = layers.param(layers.init_rms_scale(d_model, dtype, device))
        self.wq = layers.dense_param(gen, (d_model, H * dh), dtype, device)
        self.wk = layers.dense_param(gen, (d_model, Hkv * dh), dtype, device)
        self.wv = layers.dense_param(gen, (d_model, Hkv * dh), dtype, device)
        self.wo = layers.dense_param(gen, (H * dh, d_model), dtype, device)
        if dims.qkv_bias:
            self.bq = layers.param(torch.zeros((H * dh,), dtype=dtype, device=device))
            self.bk = layers.param(torch.zeros((Hkv * dh,), dtype=dtype, device=device))
            self.bv = layers.param(torch.zeros((Hkv * dh,), dtype=dtype, device=device))
        if dims.qk_norm:
            self.q_norm = layers.param(layers.init_rms_scale(dh, dtype, device))
            self.k_norm = layers.param(layers.init_rms_scale(dh, dtype, device))

    def _project_qkv(self, x: torch.Tensor, positions: torch.Tensor):
        B, S, _ = x.shape
        d = self.dims
        q = x @ self.wq
        k = x @ self.wk
        v = x @ self.wv
        if d.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = q.reshape(B, S, d.n_heads, d.d_head)
        k = k.reshape(B, S, d.n_kv_heads, d.d_head)
        v = v.reshape(B, S, d.n_kv_heads, d.d_head)
        if d.qk_norm:
            q = layers.rms_norm(q, self.q_norm)
            k = layers.rms_norm(k, self.k_norm)
        q = layers.apply_rope(q, positions, d.rope_theta)
        k = layers.apply_rope(k, positions, d.rope_theta)
        return q, k, v

    def _attend_full(self, x, positions, use_kernel):
        """Attention over the whole sequence: (output, k, v), k and v in the
        cache layout (B, S, Hkv, dh)."""
        B, S, _ = x.shape
        h = layers.rms_norm(x, self.norm_scale)
        q, k, v = self._project_qkv(h, positions)
        out = ops.multihead_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=self.dims.causal, use_kernel=use_kernel,
        )
        out = out.transpose(1, 2).reshape(B, S, self.dims.n_heads * self.dims.d_head)
        return x + out @ self.wo, k, v

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                use_kernel: Optional[bool] = None) -> torch.Tensor:
        """Full-sequence attention (training / prefill).  x: (B, S, d_model)."""
        return self._attend_full(x, positions, use_kernel)[0]

    def prefill(self, x: torch.Tensor, positions: torch.Tensor, S_max: int,
                use_kernel: Optional[bool] = None) -> Tuple[torch.Tensor, KVCache]:
        """Forward + cache fill (cache zero-padded to S_max)."""
        y, k, v = self._attend_full(x, positions, use_kernel)
        cache = init_cache(x.shape[0], S_max, self.dims, k.dtype, k.device)
        S = x.shape[1]
        cache.k[:, :S] = k
        cache.v[:, :S] = v
        return y, cache

    def decode_step(self, x: torch.Tensor, cache: KVCache,
                    pos: torch.Tensor) -> Tuple[torch.Tensor, KVCache]:
        """One-token decode against a (B, S_max) KV cache; x: (B, 1, d_model),
        pos: (B,) the new token's index.  Entries of the cache beyond ``pos``
        are masked.

        The new k and v are written into ``cache`` in place at ``pos``.  The
        JAX package adds them through a one-hot over S_max instead; the slot
        at ``pos`` is still zero (prefill pads with zeros and each step writes
        one new slot), so the two give the same cache.
        """
        B = x.shape[0]
        d = self.dims
        H, Hkv, dh = d.n_heads, d.n_kv_heads, d.d_head
        h = layers.rms_norm(x, self.norm_scale)
        q, k_new, v_new = self._project_qkv(h, pos[:, None])
        rows = torch.arange(B, device=x.device)
        cache.k[rows, pos] = k_new[:, 0]
        cache.v[rows, pos] = v_new[:, 0]
        S_max = cache.k.shape[1]
        group = H // Hkv
        qg = q.reshape(B, 1, Hkv, group, dh)
        scores = torch.einsum("bqhgd,bshd->bhgqs", qg, cache.k).float()
        scores = scores / (dh ** 0.5)
        valid = (torch.arange(S_max, device=x.device)[None, :] <= pos[:, None])
        scores = scores.masked_fill(~valid[:, None, None, None, :], NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhgqs,bshd->bqhgd", probs.to(cache.v.dtype), cache.v)
        out = out.reshape(B, 1, H * dh)
        return x + out @ self.wo, cache
