"""MLA and MoE on the card (marker ``gpu``).

Each test decides inside the ``cuda`` fixture whether a card is present and
skips with a reason when not; run them on the card with
``pytest -m gpu tests/``.

The kernel-against-plain comparison pins the routes: with random weights a
router's softmax is near-uniform, so two bf16 runs that differ only in
attention's roundings may pick other experts for a few tokens, and their
logits then differ by more than rounding.  The first run's expert ids are
recorded at ``moe.route`` and replayed (with this run's gates at those ids)
in the others; ``chip_smoke.py`` phase 15 does the same at full width.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import variant
from repro_torch.models import mla, moe
from repro_torch.models.model import Transformer, loss_fn

from _torch_moe_routes import routes

pytestmark = pytest.mark.gpu

ARCH = "deepseek-v2-lite-16b"
# (qk_nope_dim, qk_rope_dim, v_head_dim): DeepSeek-V2's head sizes (the
# wgmma variant at d = 192, dv = 128) and the reduced config's (scalar)
HEADS = {"192/128": (128, 64, 128), "24/16": (16, 8, 16)}


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _cfg(heads, dtype="bfloat16"):
    nope, rope, v = HEADS[heads]
    cfg = configs.get_reduced(ARCH)
    return dataclasses.replace(cfg, dtype=dtype, mla=cfg.mla._replace(
        qk_nope_dim=nope, qk_rope_dim=rope, v_head_dim=v))


@pytest.mark.parametrize("heads", list(HEADS))
def test_mla_model_on_card_kernel_vs_plain(cuda, monkeypatch, heads):
    """The reduced DeepSeek model in bf16: one flash launch per MLA layer in
    prefill, on the wgmma variant at 192/128; its last-token logits no
    further from an fp32 copy than twice the plain-attention bf16 model's
    (the fp32-witness rule of ``tests/test_torch_lm.py``), routes pinned."""
    cfg = _cfg(heads)
    nope, rope, v = HEADS[heads]
    expected = "wgmma" if heads == "192/128" else "scalar"
    assert variant(torch.bfloat16, nope + rope, v) == expected
    model = Transformer(cfg, device=cuda, seed=0)
    model32 = Transformer.from_params(dataclasses.replace(cfg, dtype="float32"),
                                      model.state_dict(), device=cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 64)))
    toks = toks.to(cuda)
    ids = []
    with torch.no_grad():
        ops.reset_launch_counts()
        with routes(monkeypatch, ids, record=True):
            got, _ = model.prefill(toks, S_max=70)
        assert ops.launch_counts()["flash_attention"] == cfg.n_periods
        with routes(monkeypatch, ids, record=False):
            plain, _ = model.prefill(toks, S_max=70, use_kernel=False)
        with routes(monkeypatch, ids, record=False):
            want, _ = model32.prefill(toks, S_max=70, use_kernel=False)
    err_kernel = float((got.float() - want).abs().max())
    err_plain = float((plain.float() - want).abs().max())
    assert err_kernel <= 2 * err_plain, (err_kernel, err_plain)


def _block(cuda, dtype, E=64, k=6, d=256, f=128, n_shared=2, seed=0):
    dims = moe.MoEDims(num_experts=E, top_k=k, d_ff=f, n_shared=n_shared)
    block = moe.MoE(d, dims, dtype, cuda, torch.Generator(device=cuda).manual_seed(seed))
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((4, 512, d)))
    return block, x.to(device=cuda, dtype=dtype)


def test_moe_dispatch_same_bits_twice_on_card(cuda):
    """Dispatch and combine add no floats with atomics: two calls on the
    card give the same bits (bf16, 2,048 tokens, 64 experts, top-6, some
    pairs dropped at the default capacity)."""
    block, x = _block(cuda, torch.bfloat16)
    with torch.no_grad():
        a, aux_a = block(x)
        b, aux_b = block(x)
        h = torch.randn(2048, 256, device=cuda, dtype=torch.bfloat16)
        _, _, eidx = moe.route(h, block.router, block.dims)
        plan = moe.dispatch_plan(eidx, 64, moe.capacity(2048, block.dims))
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    assert bool(torch.isfinite(a.float()).all())
    kept = plan.slot[plan.keep]
    assert kept.unique().numel() == kept.numel()


def test_routing_on_card_equals_cpu_zero_router(cuda):
    """A zero router ties every expert: the card takes the lowest ids, as
    the CPU (and ``jax.lax.top_k``) does, and plans the same dispatch."""
    block, x = _block(cuda, torch.float32, E=16, k=4)
    h = x.reshape(-1, x.shape[-1])
    router = torch.zeros_like(block.router)
    probs, gates, eidx = moe.route(h, router, block.dims)
    cprobs, cgates, cidx = moe.route(h.cpu(), router.cpu(), block.dims)
    assert torch.equal(eidx.cpu(), cidx)
    assert torch.equal(cidx, torch.arange(4).expand_as(cidx))
    assert torch.equal(gates.cpu(), cgates)
    C = moe.capacity(h.shape[0], block.dims)
    for a, b in zip(moe.dispatch_plan(eidx, 16, C), moe.dispatch_plan(cidx, 16, C)):
        assert torch.equal(a.cpu(), b)


def test_mla_train_step_on_card(cuda):
    """One loss and gradient of the reduced DeepSeek model at 192/128 (bf16,
    remat full): two flash launches a MLA layer (forward and recompute),
    every MLA and MoE weight with a finite, non-zero gradient."""
    cfg = _cfg("192/128")
    model = Transformer(cfg, device=cuda, seed=0)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 65)))
    params = dict(model.named_parameters())
    ops.reset_launch_counts()
    loss = loss_fn(model, {"tokens": toks.to(cuda)})
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    assert ops.launch_counts()["flash_attention"] == 2 * cfg.n_periods
    assert np.isfinite(float(loss.detach()))
    for i, blk in enumerate(model.blocks):
        if isinstance(blk, (mla.MLA, moe.MoE)):
            for leaf, _ in blk.named_parameters():
                g = grads[f"blocks.{i}.{leaf}"]
                assert bool(torch.isfinite(g.float()).all()), leaf
                assert bool(torch.any(g != 0)), f"blocks.{i}.{leaf}"
