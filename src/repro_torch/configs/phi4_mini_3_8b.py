"""phi4-mini-3.8b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064 — RoPE SwiGLU GQA.  [arXiv:2412.08905; hf]"""

from ..models.model import ModelConfig

ARCH_ID = "phi4-mini-3.8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_periods=32, period=("attn", "mlp"),
        d_model=3072, vocab_size=200064,
        n_heads=24, n_kv_heads=8, d_head=128,
        qk_norm=False, qkv_bias=False, rope_theta=1e4,
        d_ff=8192, tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_periods=2, period=("attn", "mlp"),
        d_model=64, vocab_size=256,
        n_heads=4, n_kv_heads=2, d_head=16,
        qk_norm=False, qkv_bias=False, rope_theta=1e4,
        d_ff=128, tie_embeddings=True, dtype="float32",
    )
