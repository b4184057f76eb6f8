"""Shared neural blocks of the LM substrate: RMS norm, RoPE, MLPs, initializers.

Counterpart of ``src/repro/models/layers.py``, M-RoPE included.  The order of casts follows the JAX package, so bf16
rounds at the same places: the norm and the rotation run in fp32 and are cast
back before the scale or the next product.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dtype) * scale


def rope_freqs(d_head_rot: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for the rotary half-dim (d_head_rot // 2), fp32."""
    half = d_head_rot // 2
    expo = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(float(theta), expo)  # a Python base: no host-to-device copy


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Standard RoPE over the full head dim.  x: (B, S, H, dh); positions (B, S)."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, device=x.device)
    ang = positions[..., None].float() * inv[None, None, :]  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """M-RoPE (Qwen2-VL): the rotary half-dim is cut into (temporal, height,
    width) sections, each rotated by its own position id.
    x: (B, S, H, dh); positions: (B, S, 3); ``sections`` sums to dh // 2."""
    B, S, H, dh = x.shape
    if sum(sections) != dh // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {dh // 2}")
    inv = rope_freqs(dh, theta, device=x.device)
    pos = torch.cat([positions[..., i:i + 1].expand(B, S, sec)
                     for i, sec in enumerate(sections)], dim=-1)  # (B, S, half)
    ang = pos.float() * inv[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def text_mrope_positions(positions: torch.Tensor) -> torch.Tensor:
    """Pure-text M-RoPE: t = h = w = sequence index.  (B, S) -> (B, S, 3)."""
    return positions[..., None].expand(*positions.shape, 3)


def swiglu(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """Fused-gate SwiGLU: w_in packs [gate | up] along the output dim."""
    gate, up = (x @ w_in).chunk(2, dim=-1)
    return (F.silu(gate) * up) @ w_out


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    return F.gelu(x @ w_in, approximate="tanh") @ w_out


# ---------------------------------------------------------------------------
# Initializers: an explicit generator on the tensor's device, fp32 draws cast
# to the model's type (the JAX package draws with jax.random; the two give
# different numbers from one seed, so parity tests carry weights across).
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype, device,
               in_axis: int = 0) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut at +-2, times
    1/sqrt(shape[in_axis]).  A 3-D stack (MoE experts) is drawn one slice of
    its leading axis at a time, so the fp32 draw never holds the whole stack
    (a Kimi-K2 layer's ``w_in`` is 45 GB in fp32)."""
    scale = 1.0 / shape[in_axis] ** 0.5
    if len(shape) == 3:
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
        for i in range(shape[0]):
            out[i] = (_trunc_normal(gen, shape[1:], device) * scale).to(dtype)
        return out
    return (_trunc_normal(gen, shape, device) * scale).to(dtype)


def _trunc_normal(gen: torch.Generator, shape: Sequence[int], device) -> torch.Tensor:
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=gen)


def embed_init(gen: torch.Generator, shape: Sequence[int], dtype, device) -> torch.Tensor:
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    w.normal_(0.0, 1.0, generator=gen)
    return (w * 0.02).to(dtype)


def init_rms_scale(d: int, dtype, device) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def param(t: torch.Tensor) -> nn.Parameter:
    """A trainable weight.  The serving paths run under ``torch.no_grad()``
    (``Transformer.prefill``/``decode_step``), so they keep no autograd
    state for it."""
    return nn.Parameter(t)


def dense_param(gen: Optional[torch.Generator], shape: Sequence[int], dtype,
                device, in_axis: int = 0) -> nn.Parameter:
    """A dense weight drawn from ``gen`` (fan-in ``shape[in_axis]``), or left
    uninitialized without one (to be loaded)."""
    if gen is None:
        return param(torch.empty(tuple(shape), dtype=dtype, device=device))
    return param(dense_init(gen, shape, dtype, device, in_axis=in_axis))


class Stateless:
    """The serving methods of a sub-block that keeps no cache (MLP, MoE):
    its prefill and its decode step are its ``forward``, the aux loss
    dropped, so the model runs every sub-block through one interface."""

    def init_cache(self, B: int, S_max: int, dtype, device) -> None:
        return None

    def prefill(self, x: torch.Tensor, positions: torch.Tensor, S_max: int,
                use_kernel: Optional[bool] = None):
        return self(x, positions, use_kernel)[0], None

    def decode_step(self, x: torch.Tensor, cache: None, pos: torch.Tensor):
        return self(x, pos[:, None])[0], cache
