"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 —
encoder-only; the modality frontend is a STUB per the assignment
(input_specs provide precomputed frame embeddings).  No decode shapes.
[arXiv:2106.07447; unverified]

Adaptation note (DESIGN.md): HuBERT's conv feature extractor and conv
positional embedding are stubbed; the transformer backbone uses RoPE and
SwiGLU in place of learned-abs-pos + GELU (backbone-equivalent compute).
"""

from ..models.model import ModelConfig

ARCH_ID = "hubert-xlarge"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="audio",
        n_periods=48, period=("attn", "mlp"),
        d_model=1280, vocab_size=504,
        n_heads=16, n_kv_heads=16, d_head=80,
        d_ff=5120, causal=False,
        frontend="frames", supports_decode=False,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="audio",
        n_periods=2, period=("attn", "mlp"),
        d_model=64, vocab_size=64,
        n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, causal=False,
        frontend="frames", supports_decode=False, dtype="float32",
    )
