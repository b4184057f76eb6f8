"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) expert d_ff=2048
vocab=163840, MoE 384 routed experts top-8 + 1 shared — trillion-param MoE.
[arXiv:2501.kimi2; unverified]

Per the assignment table we model attention as GQA (kv=8); ~1.03T total
params, ~32B active per token (8/384 experts + shared + attention).
Single-pod (256 chip) training memory is over the v5e HBM budget even with
8-bit optimizer states — see EXPERIMENTS.md §Dry-run; the multi-pod mesh is
the supported training topology.
"""

from ..models.model import ModelConfig
from ..models.moe import MoEDims

ARCH_ID = "kimi-k2-1t-a32b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_periods=61, period=("attn", "moe"),
        d_model=7168, vocab_size=163840,
        n_heads=64, n_kv_heads=8, d_head=128,
        qk_norm=False, qkv_bias=False, rope_theta=5e4,
        moe=MoEDims(num_experts=384, top_k=8, d_ff=2048, n_shared=1),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe",
        n_periods=2, period=("attn", "moe"),
        d_model=64, vocab_size=256,
        n_heads=4, n_kv_heads=2, d_head=16,
        rope_theta=5e4,
        # capacity_factor=0 -> dropless routing: decode matches batch forward
        moe=MoEDims(num_experts=8, top_k=2, d_ff=32, n_shared=1,
                    capacity_factor=0.0),
        dtype="float32",
    )
