"""qwen1.5-4b [dense]: 40L d_model=2560 20H (GQA kv=20 = MHA) d_ff=6912
vocab=151936 — QKV bias.  [hf:Qwen/Qwen1.5 family; hf]"""

from ..models.model import ModelConfig

ARCH_ID = "qwen1.5-4b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_periods=40, period=("attn", "mlp"),
        d_model=2560, vocab_size=151936,
        n_heads=20, n_kv_heads=20, d_head=128,
        qk_norm=False, qkv_bias=True, rope_theta=1e6,
        d_ff=6912,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_periods=2, period=("attn", "mlp"),
        d_model=64, vocab_size=256,
        n_heads=4, n_kv_heads=4, d_head=16,
        qk_norm=False, qkv_bias=True, rope_theta=1e6,
        d_ff=128, dtype="float32",
    )
