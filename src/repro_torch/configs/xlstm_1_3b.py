"""xlstm-1.3b [ssm]: 48L d_model=2048 4H vocab=50304, d_ff=0 — sLSTM + mLSTM
blocks (7:1 mLSTM:sLSTM interleave), recurrent O(1)/token decode, so the
long_500k cell runs.  [arXiv:2405.04517; unverified]"""

from ..models.model import ModelConfig
from ..models.ssm import MLSTMDims, SLSTMDims

ARCH_ID = "xlstm-1.3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="ssm",
        n_periods=6,
        period=("mlstm",) * 7 + ("slstm",),
        d_model=2048, vocab_size=50304,
        mlstm=MLSTMDims(d_inner=4096, n_heads=4),
        slstm=SLSTMDims(n_heads=4),
        sub_quadratic=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="ssm",
        n_periods=2, period=("mlstm", "mlstm", "slstm"),
        d_model=64, vocab_size=256, ssm_chunk=16,
        mlstm=MLSTMDims(d_inner=128, n_heads=4),
        slstm=SLSTMDims(n_heads=4),
        sub_quadratic=True, dtype="float32",
    )
