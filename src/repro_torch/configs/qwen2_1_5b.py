"""qwen2-1.5b [dense]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936
— GQA, QKV bias, tied embeddings.  [arXiv:2407.10671; hf]"""

from ..models.model import ModelConfig

ARCH_ID = "qwen2-1.5b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_periods=28, period=("attn", "mlp"),
        d_model=1536, vocab_size=151936,
        n_heads=12, n_kv_heads=2, d_head=128,
        qk_norm=False, qkv_bias=True, rope_theta=1e6,
        d_ff=8960, tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_periods=2, period=("attn", "mlp"),
        d_model=64, vocab_size=256,
        n_heads=4, n_kv_heads=2, d_head=16,
        qk_norm=False, qkv_bias=True, rope_theta=1e6,
        d_ff=128, tie_embeddings=True, dtype="float32",
    )
