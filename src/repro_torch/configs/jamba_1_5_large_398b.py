"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2 — Mamba+attention 1:7 interleave, MoE every other
layer.  [arXiv:2403.19887; hf]

Period = 8 layers: attention at in-period index 4, Mamba elsewhere; the FFN
of every odd layer is MoE, even layers dense.  Mamba d_inner = 2*d_model,
d_state=16, conv=4.  Mamba state gives O(1)/token decode for the 63 Mamba
layers; the 9 attention layers keep a (sharded) KV cache, so the long_500k
decode cell runs.
"""

from ..models.model import ModelConfig
from ..models.moe import MoEDims
from ..models.ssm import MambaDims

ARCH_ID = "jamba-1.5-large-398b"


def _period():
    blocks = []
    for i in range(8):
        blocks.append("attn" if i == 4 else "mamba")
        blocks.append("moe" if i % 2 == 1 else "mlp")
    return tuple(blocks)


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="hybrid",
        n_periods=9, period=_period(),
        d_model=8192, vocab_size=65536,
        n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=24576,
        mamba=MambaDims(d_inner=16384, d_state=16, d_conv=4),
        moe=MoEDims(num_experts=16, top_k=2, d_ff=24576),
        sub_quadratic=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="hybrid",
        n_periods=1, period=_period(),
        d_model=64, vocab_size=256,
        n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, ssm_chunk=16,
        mamba=MambaDims(d_inner=128, d_state=8, d_conv=4),
        moe=MoEDims(num_experts=4, top_k=2, d_ff=64),
        sub_quadratic=True, dtype="float32",
    )
