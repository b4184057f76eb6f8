"""Chunked attention (``get_optimized``'s ``attn_impl="chunked"``) against
the flash kernel on the card (marker ``gpu``).

Each test decides inside the ``cuda`` fixture whether a card is present and
skips with a reason when not; run them on the card with
``pytest -m gpu tests/``.

bf16 inputs of a small shape, causal and not, GQA and dv != d: the chunked
online softmax (plain PyTorch ops on the card, chunks of 64 keys) and the
flash kernel each against the plain version computed in fp32 from the same
bf16 inputs, within ``chip_smoke.py``'s ``FLASH_TOL`` = 2e-2 (the JAX
package's tolerance for its bf16 flash kernel: the output's own bf16
rounding is up to 2^-9 relative, p's rounding to bf16 adds as much again),
and against each other within twice that.  The chunked path launches no
flash kernel unless Sk is ragged, where it falls back to it.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.models import attention

pytestmark = pytest.mark.gpu

FLASH_TOL = 2e-2
# (B, Hq, Hkv, S, d, dv)
SHAPES = {"gqa4": (2, 8, 2, 256, 128, 128), "mla-dv": (2, 4, 4, 256, 192, 128)}


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _qkv(shape, dev, seed=0):
    B, Hq, Hkv, S, d, dv = shape
    rng = np.random.default_rng(seed)

    def t(*dims):
        return torch.from_numpy(rng.standard_normal(dims).astype(np.float32)).to(
            dev, torch.bfloat16)

    return t(B, Hq, S, d), t(B, Hkv, S, d), t(B, Hkv, S, dv)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_chunked_attention_against_flash_kernel(cuda, name, causal):
    shape = SHAPES[name]
    q, k, v = _qkv(shape, cuda)
    B, Hq, Hkv, S, d, dv = shape
    dims = attention.AttnDims(Hq, Hkv, d, False, False, 1e4, causal, impl="chunked", chunk=64)
    ops.reset_launch_counts()
    chunked = attention.attend(q, k, v, dims, None)
    assert ops.launch_counts()["flash_attention"] == 0
    flash = ops.multihead_attention(q, k, v, causal=causal)
    assert ops.launch_counts()["flash_attention"] == 1
    want = ops.multihead_attention(q.float(), k.float(), v.float(), causal=causal,
                                   use_kernel=False)
    assert chunked.dtype == torch.bfloat16 and chunked.shape == (B, Hq, S, dv)
    for got in (chunked, flash):
        assert float((got.float() - want).abs().max()) <= FLASH_TOL
    assert float((chunked.float() - flash.float()).abs().max()) <= 2 * FLASH_TOL


def test_chunked_ragged_falls_back_to_flash_kernel(cuda):
    """Sk not a multiple of the chunk: the reference's fallback, here the
    flash kernel itself (its bits)."""
    q, k, v = _qkv(SHAPES["gqa4"], cuda, seed=1)
    dims = attention.AttnDims(8, 2, 128, False, False, 1e4, True, impl="chunked", chunk=96)
    ops.reset_launch_counts()
    got = attention.attend(q, k, v, dims, None)
    assert ops.launch_counts()["flash_attention"] == 1
    assert torch.equal(got, ops.multihead_attention(q, k, v, causal=True))
