"""The SSM, hybrid, VLM and audio families on the card (marker ``gpu``).

Each test decides inside the ``cuda`` fixture whether a card is present and
skips with a reason when not; run them on the card with
``pytest -m gpu tests/``.

The reduced configs in fp32 on the card against the same weights on the
CPU, TF32 off: rtol 1e-4 / atol 1e-4.  The same fp32 products are summed
in another order on each device (cuBLAS against the CPU's BLAS, the flash
kernel's fp32 variant against the plain softmax), a few ulps of each
product; the recurrences and the head carry that to ~1e-6 of the logits'
scale (~4), so 1e-4 leaves a margin of ~25x and TF32 (2^-11 a product)
would exceed it.  The bf16 head shapes of the full-size models (Qwen2-VL's
GQA group 6 at d = 128, HuBERT's d = 80 non-causal; both on the wgmma
variant) are held by the fp32-witness rule of
``tests/test_torch_lm.py``: no further from an fp32 copy than twice the
plain-attention bf16 model.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import variant
from repro_torch.models.model import Transformer

pytestmark = pytest.mark.gpu

ARCHS = ["xlstm-1.3b", "jamba-1.5-large-398b", "qwen2-vl-2b", "hubert-xlarge"]
TOL = 1e-4


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _inputs(cfg, S, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "tokens":
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S)))
    return torch.from_numpy(rng.standard_normal((2, S, cfg.d_model)).astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_model_on_card_matches_cpu(cuda, arch):
    """Forward logits; for the decoding archs also the prefill's last logits
    and two decode steps (the recurrent states advanced in place on the
    card); one flash launch per attention layer in a forward."""
    cfg = configs.get_reduced(arch)
    cpu = Transformer(cfg, device="cpu", seed=0)
    card = Transformer.from_params(cfg, cpu.state_dict(), device=cuda)
    x = _inputs(cfg, 32)
    n_attn = cfg.n_periods * cfg.period.count("attn")
    with torch.no_grad():
        want, _ = cpu(x)
        ops.reset_launch_counts()
        got, _ = card(x.to(cuda))
        assert ops.launch_counts()["flash_attention"] == n_attn
        torch.testing.assert_close(got.cpu(), want, rtol=TOL, atol=TOL)
        if cfg.frontend != "tokens":
            return
        lw, cw = cpu.prefill(x[:, :16], S_max=18)
        lg, cg = card.prefill(x[:, :16].to(cuda), S_max=18)
        torch.testing.assert_close(lg.cpu(), lw, rtol=TOL, atol=TOL)
        for t in (16, 17):
            pos = torch.full((2,), t)
            dw, cw = cpu.decode_step(cw, x[:, t], pos)
            dg, cg = card.decode_step(cg, x[:, t].to(cuda), pos.to(cuda))
            torch.testing.assert_close(dg.cpu(), dw, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch,heads,kind", [
    ("qwen2-vl-2b", dict(n_heads=12, n_kv_heads=2, d_head=128,
                         mrope_sections=(16, 24, 24)), "wgmma"),
    ("hubert-xlarge", dict(n_heads=4, n_kv_heads=4, d_head=80), "wgmma"),
])
def test_head_shapes_on_card_kernel_vs_plain(cuda, arch, heads, kind):
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="bfloat16", **heads)
    assert variant(torch.bfloat16, cfg.d_head, cfg.d_head) == kind
    model = Transformer(cfg, device=cuda, seed=0)
    model32 = Transformer.from_params(dataclasses.replace(cfg, dtype="float32"),
                                      model.state_dict(), device=cuda)
    x = _inputs(cfg, 64).to(cuda)
    with torch.no_grad():
        ops.reset_launch_counts()
        got, _ = model(x)
        assert ops.launch_counts()["flash_attention"] == cfg.n_periods
        plain, _ = model(x, use_kernel=False)
        want, _ = model32(x, use_kernel=False)
    err_kernel = float((got.float() - want).abs().max())
    err_plain = float((plain.float() - want).abs().max())
    assert bool(torch.isfinite(got).all()) and err_kernel <= 2 * err_plain, (err_kernel,
                                                                               err_plain)
