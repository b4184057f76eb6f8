"""qwen3-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936
— qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]"""

from ..models.model import ModelConfig

ARCH_ID = "qwen3-8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_periods=36, period=("attn", "mlp"),
        d_model=4096, vocab_size=151936,
        n_heads=32, n_kv_heads=8, d_head=128,
        qk_norm=True, qkv_bias=False, rope_theta=1e6,
        d_ff=12288,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_periods=2, period=("attn", "mlp"),
        d_model=64, vocab_size=256,
        n_heads=4, n_kv_heads=1, d_head=16,
        qk_norm=True, qkv_bias=False, rope_theta=1e6,
        d_ff=128, dtype="float32",
    )
