"""Launcher of the hand-written CUDA flash attention (``csrc/flash_attention.cu``).

The CUDA counterpart of the Pallas kernel ``flash_attention``
(``src/repro/kernels/flash_attention.py``): online-softmax attention over
flattened heads, ``q (B*Hq, Sq, d)``, ``k (B*Hkv, Sk, d)``, ``v (B*Hkv, Sk,
dv)``, query head ``h`` reading kv head ``h // q_heads_per_kv``.  The kernel
masks the ragged edges itself, so nothing is padded here.  bf16 head sizes
(128, 128), (64, 64) and (192, 128) run the wgmma + TMA variant; fp32, and
other bf16 head sizes up to 256, run the scalar variant.  The
plain PyTorch version is :func:`repro_torch.kernels.ref.attention_ref`;
dispatch lives in :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import torch

from . import _build

# kernel launches made through this wrapper, by Pallas kernel name
launches = {"flash_attention": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
VARIANTS = ("scalar", "wgmma")


def variant(dtype: torch.dtype, d: int, dv: int) -> str:
    """The kernel a call with this type and these head sizes takes, one of
    :data:`VARIANTS`."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {dtype}")
    return VARIANTS[_build.library().repro_flash_attention_variant(_DTYPES[dtype], d, dv)]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernels' vector and
    TMA loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q, k, v, *, causal: bool = True, q_heads_per_kv: int = 1):
    """Attention of ``q`` over ``k``/``v`` on the card, a new ``(B*Hq, Sq, dv)``
    tensor in q's type.  ``causal`` needs ``Sq == Sk`` (top-left and
    bottom-right alignment agree only there)."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got {device}")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k and v must be 3-D (flattened heads, sequence, head dim)")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != device or t.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype} on {device}")
    BHq, Sq, d = q.shape
    BHkv, Sk, dk = k.shape
    dv = v.shape[2]
    group = int(q_heads_per_kv)
    if dk != d or v.shape[:2] != (BHkv, Sk):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if group < 1 or BHq != BHkv * group:
        raise ValueError(f"B*Hq={BHq} is not B*Hkv={BHkv} times q_heads_per_kv={group}")
    if min(BHq, Sq, Sk) < 1 or max(d, dv) > MAX_HEAD_DIM:
        raise ValueError(f"unsupported sizes Sq={Sq} Sk={Sk} d={d} dv={dv}")
    if causal and Sq != Sk:
        raise ValueError(f"causal attention needs Sq == Sk, got {Sq} and {Sk}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((BHq, Sq, dv), dtype=q.dtype, device=device)
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            BHq, Sq, Sk, d, dv, group, int(bool(causal)), _DTYPES[q.dtype], stream,
        )
    _build.check(err, "flash_attention")
    launches["flash_attention"] += 1
    return out
