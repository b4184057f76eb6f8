"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936
— M-RoPE (temporal/height/width rotary sections), dynamic resolution.
[arXiv:2409.12191; hf]

The vision frontend is a STUB per the assignment: the backbone consumes
token ids; M-RoPE positions default to text mode (t=h=w=index).  d_head=128
-> rotary half-dim 64 split into sections (16, 24, 24) as in the release.
"""

from ..models.model import ModelConfig

ARCH_ID = "qwen2-vl-2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="vlm",
        n_periods=28, period=("attn", "mlp"),
        d_model=1536, vocab_size=151936,
        n_heads=12, n_kv_heads=2, d_head=128,
        qkv_bias=True, rope_theta=1e6,
        mrope_sections=(16, 24, 24),
        d_ff=8960, tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="vlm",
        n_periods=2, period=("attn", "mlp"),
        d_model=64, vocab_size=256,
        n_heads=4, n_kv_heads=2, d_head=16,
        qkv_bias=True, rope_theta=1e6,
        mrope_sections=(2, 3, 3),
        d_ff=128, tie_embeddings=True, dtype="float32",
    )
