"""Shared neural blocks of the LM substrate: RMS norm, RoPE, MLPs, initializers.

Counterpart of ``src/repro/models/layers.py`` (M-RoPE is not ported: ROADMAP
queue 1 item 14f).  The order of casts follows the JAX package, so bf16
rounds at the same places: the norm and the rotation run in fp32 and are cast
back before the scale or the next product.
"""

from __future__ import annotations

from typing import Optional, Sequence

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
    """Truncated-normal fan-in init: N(0, 1) cut at +-2, times 1/sqrt(fan_in)."""
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=gen)
    return (w * (1.0 / shape[in_axis] ** 0.5)).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int], dtype, device) -> torch.Tensor:
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    w.normal_(0.0, 1.0, generator=gen)
    return (w * 0.02).to(dtype)


def init_rms_scale(d: int, dtype, device) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def param(t: torch.Tensor) -> nn.Parameter:
    """A weight of the serving path (training is ROADMAP queue 1 item 14b)."""
    return nn.Parameter(t, requires_grad=False)


def dense_param(gen: Optional[torch.Generator], shape: Sequence[int], dtype,
                device) -> nn.Parameter:
    """A dense weight drawn from ``gen``, or left uninitialized without one
    (to be loaded)."""
    if gen is None:
        return param(torch.empty(tuple(shape), dtype=dtype, device=device))
    return param(dense_init(gen, shape, dtype, device))
