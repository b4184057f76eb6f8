"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H, MLA kv_lora=512,
expert d_ff=1408, vocab=102400, MoE 64 routed top-6 + 2 shared.
[arXiv:2405.04434; hf]

MLA head dims follow the paper: qk_nope=128, qk_rope=64, v=128.
"""

from ..models.mla import MLADims
from ..models.model import ModelConfig
from ..models.moe import MoEDims

ARCH_ID = "deepseek-v2-lite-16b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_periods=27, period=("mla", "moe"),
        d_model=2048, vocab_size=102400,
        rope_theta=1e4,
        mla=MLADims(n_heads=16, kv_lora_rank=512, qk_nope_dim=128,
                    qk_rope_dim=64, v_head_dim=128, rope_theta=1e4),
        moe=MoEDims(num_experts=64, top_k=6, d_ff=1408, n_shared=2),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe",
        n_periods=2, period=("mla", "moe"),
        d_model=64, vocab_size=256,
        rope_theta=1e4,
        mla=MLADims(n_heads=4, kv_lora_rank=16, qk_nope_dim=16,
                    qk_rope_dim=8, v_head_dim=16, rope_theta=1e4),
        # capacity_factor=0 -> dropless routing: decode matches batch forward
        moe=MoEDims(num_experts=8, top_k=2, d_ff=32, n_shared=2,
                    capacity_factor=0.0),
        dtype="float32",
    )
