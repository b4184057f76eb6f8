"""GQA attention block (qk-norm / QKV-bias / M-RoPE variants) with a KV
cache, causal or not (``AttnDims.causal``: an encoder attends both ways).

Counterpart of ``src/repro/models/attention.py``.  The full-sequence paths
(``forward``, ``prefill``) attend through :func:`attend`: with
``impl="reference"`` (the default) through
:func:`repro_torch.kernels.ops.multihead_attention`, the hand-written flash
kernel on the card and the plain version on the CPU; with ``impl="chunked"``
through :func:`_chunked_attention`, the reference's online softmax over KV
chunks in plain PyTorch ops on every device (the reference computes it
outside any Pallas kernel: it is the ``get_optimized`` profile's attention,
not a plain version of the flash kernel).  Decode is dense one-token
attention over the cache in plain PyTorch ops, as in the JAX package (it
reads the whole cache once and is bound by that read).  Weights keep the JAX
layout, ``(in, out)``, so ``x @ w``.

Under a model axis (:mod:`repro_torch.runtime.tensor_parallel`) a rank holds
``H / k`` query heads (its columns of ``wq``, rows of ``wo``) and computes
the KV heads they read: its block of ``Hkv / k`` heads, or, where ``k`` does
not divide ``Hkv``, those of its query heads out of the whole ``wk`` / ``wv``
(gathered by the plan), expanded to one a query head where the grouping is
uneven.  The normed input goes through ``f`` and ``wo``'s output through
``g``; a decode cache holds the rank's KV heads.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..kernels import ops
from ..kernels.ref import NEG_INF
from ..runtime import tensor_parallel as tp
from . import hints, layers


class AttnDims(NamedTuple):
    n_heads: int
    n_kv_heads: int
    d_head: int
    qk_norm: bool
    qkv_bias: bool
    rope_theta: float
    causal: bool
    mrope_sections: Optional[Tuple[int, int, int]] = None  # M-RoPE if set
    impl: str = "reference"  # "reference" (the flash kernel) | "chunked"
    chunk: int = 1024
    unroll: bool = False  # the reference's cost extraction (eager: no effect)


def _chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dims,
                       use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``dims.chunk`` keys: the
    reference's ``lax.scan`` as a Python loop, so the score matrix never
    exceeds (Sq, chunk) a head.  q: (B, H, Sq, dh); k, v: (B, Hkv, Sk, dh*).

    The reference's casts: each chunk's scores are formed in the inputs'
    type, then scaled in fp32, masked with -1e30 (causal), and the
    probabilities are cast to v's type for the product, accumulated in fp32
    and cast back at the end.  A ragged Sk (not a multiple of the chunk)
    goes to :func:`ops.multihead_attention` (the flash kernel on the card),
    as the reference falls back to its reference path.  ``dims``: anything
    with ``chunk`` and ``causal`` (:class:`AttnDims`, ``mla.MLADims``)."""
    B, H, Sq, dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    group = H // Hkv
    ck = min(dims.chunk, Sk)
    if Sk % ck:
        return ops.multihead_attention(q, k, v, causal=dims.causal, use_kernel=use_kernel)
    scale = 1.0 / dh ** 0.5
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    m_run = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    s_run = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, dv), dtype=torch.float32, device=q.device)
    for start in range(0, Sk, ck):
        k_c, v_c = k[:, :, start:start + ck], v[:, :, start:start + ck]
        if group != 1:
            k_c = k_c.repeat_interleave(group, dim=1)
            v_c = v_c.repeat_interleave(group, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", q, k_c).float() * scale
        if dims.causal:
            kv_pos = start + torch.arange(ck, device=q.device)[None, :]
            s = torch.where(q_pos >= kv_pos, s, NEG_INF)
        m_new = torch.maximum(m_run, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_run - m_new)
        s_run = s_run * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(v_c.dtype), v_c).float()
        m_run = m_new
    return (acc / torch.clamp(s_run, min=1e-30)[..., None]).to(q.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dims,
           use_kernel: Optional[bool]) -> torch.Tensor:
    """(B, H, S, dh) attention by ``dims.impl``: the chunked online softmax,
    or :func:`ops.multihead_attention` (the flash kernel on the card)."""
    if dims.impl == "chunked":
        return _chunked_attention(q, k, v, dims, use_kernel)
    return ops.multihead_attention(q, k, v, causal=dims.causal, use_kernel=use_kernel)


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
        if dims.impl not in ("reference", "chunked"):
            raise ValueError(f"unknown attn_impl {dims.impl!r}")
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

    def _heads(self) -> Tuple[int, Optional[Tuple[int, int]], Optional[torch.Tensor]]:
        """``(H, kv, expand)``: the query heads this rank computes, the range
        of KV heads they read (None: every KV head, one device), and where
        that range groups unevenly over them, the KV head of each query
        head within it."""
        d = self.dims
        ms = tp.active()
        if ms is None:
            return d.n_heads, None, None
        H = d.n_heads // ms.ranks
        group = d.n_heads // d.n_kv_heads
        lo, hi = ms.index * H // group, ((ms.index + 1) * H - 1) // group + 1
        expand = None
        if H % group and group % H:
            expand = (ms.index * H + torch.arange(H, device=self.wq.device)) // group - lo
        return H, (lo, hi), expand

    def _kv_weight(self, w: torch.Tensor, kv) -> torch.Tensor:
        """This rank's KV columns of ``w``: its block as held, or cut out
        of the whole leaf (the plan gathers it where ``k`` does not divide
        the KV heads)."""
        dh = self.dims.d_head
        if kv is None or w.shape[-1] == (kv[1] - kv[0]) * dh:
            return w
        return w[..., kv[0] * dh:kv[1] * dh]

    def _project_qkv(self, x: torch.Tensor, positions: torch.Tensor):
        B, S, _ = x.shape
        d = self.dims
        H, kv, expand = self._heads()
        Hkv = d.n_kv_heads if kv is None else kv[1] - kv[0]
        q = x @ self.wq
        k = x @ self._kv_weight(self.wk, kv)
        v = x @ self._kv_weight(self.wv, kv)
        if d.qkv_bias:
            q = q + self.bq
            k = k + self._kv_weight(self.bk, kv)
            v = v + self._kv_weight(self.bv, kv)
        q = q.reshape(B, S, H, d.d_head)
        k = k.reshape(B, S, Hkv, d.d_head)
        v = v.reshape(B, S, Hkv, d.d_head)
        if expand is not None:
            k, v = k[:, :, expand], v[:, :, expand]
        if d.qk_norm:
            q = layers.rms_norm(q, self.q_norm)
            k = layers.rms_norm(k, self.k_norm)
        if d.mrope_sections is not None:
            if positions.dim() == 2:
                positions = layers.text_mrope_positions(positions)
            q = layers.apply_mrope(q, positions, d.rope_theta, d.mrope_sections)
            k = layers.apply_mrope(k, positions, d.rope_theta, d.mrope_sections)
        else:
            q = layers.apply_rope(q, positions, d.rope_theta)
            k = layers.apply_rope(k, positions, d.rope_theta)
        return q, k, v

    def _attend_full(self, x, positions, use_kernel):
        """Attention over the whole sequence: (output, k, v), k and v in the
        cache layout (B, S, Hkv, dh)."""
        B, S, _ = x.shape
        h = tp.copy_to_model(layers.rms_norm(x, self.norm_scale))
        q, k, v = self._project_qkv(h, positions)
        out = attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                     self.dims, use_kernel)
        out = out.transpose(1, 2).reshape(B, S, q.shape[2] * self.dims.d_head)
        # the reference pins the batch axes here (a no-op in eager code)
        return x + tp.reduce_from_model(hints.constrain_batch(out) @ self.wo), k, v

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                use_kernel: Optional[bool] = None) -> Tuple[torch.Tensor, None]:
        """Full-sequence attention (training / prefill).  x: (B, S, d_model).
        Returns (output, None): no aux loss."""
        return self._attend_full(x, positions, use_kernel)[0], None

    def init_cache(self, B: int, S_max: int, dtype, device) -> KVCache:
        """An empty cache of the KV heads this rank computes."""
        H, kv, expand = self._heads()
        Hkv = self.dims.n_kv_heads if kv is None else (H if expand is not None else kv[1] - kv[0])
        return init_cache(B, S_max, self.dims._replace(n_kv_heads=Hkv), dtype, device)

    def prefill(self, x: torch.Tensor, positions: torch.Tensor, S_max: int,
                use_kernel: Optional[bool] = None) -> Tuple[torch.Tensor, KVCache]:
        """Forward + cache fill (cache zero-padded to S_max)."""
        y, k, v = self._attend_full(x, positions, use_kernel)
        cache = self.init_cache(x.shape[0], S_max, k.dtype, k.device)
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
        dh = self.dims.d_head
        h = layers.rms_norm(x, self.norm_scale)
        q, k_new, v_new = self._project_qkv(h, pos[:, None])
        H, Hkv = q.shape[2], k_new.shape[2]
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
        return x + tp.reduce_from_model(out @ self.wo), cache
