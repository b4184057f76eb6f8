"""The port's VLM (Qwen2-VL: M-RoPE) and audio (HuBERT: frames frontend,
non-causal encoder) families against the JAX package, on the CPU; serving
the three new decoding architectures through the registry.

Weights and optimizer state come from the JAX package (carried with
``convert``), inputs from a numpy seed; everything is fp32, held at the LM
parity tolerance of ``tests/test_torch_lm.py``, rtol 1e-4 / atol 1e-5 (the
same products summed in another order). Text-mode M-RoPE is held to
standard RoPE bit for bit (it rotates every frequency by the same position),
and ``frame_embeddings`` to the reference's bit for bit (the same numpy
draws).
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import lm as jlm
from repro.launch.serve import serve as jserve
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.optim import AdamW as JAdamW
from repro.optim.adamw import _dequantize as jdequantize
from repro_torch import configs
from repro_torch.convert import _unstack, adamw_state_from_reference, lm_params_from_reference
from repro_torch.data import lm
from repro_torch.launch import serve as serve_mod
from repro_torch.models import layers
from repro_torch.models.model import Transformer, loss_fn, make_train_step
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import _dequantize as dequantize

RTOL, ATOL = 1e-4, 1e-5
VLM, AUDIO = "qwen2-vl-2b", "hubert-xlarge"
NEW_ARCHS = ["xlstm-1.3b", "jamba-1.5-large-398b", VLM, AUDIO]


def _carried(arch, seed=0):
    jcfg, cfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    state = lm_params_from_reference(jax.tree.map(np.asarray, jp), cfg)
    return jcfg, jp, cfg, Transformer.from_params(cfg, state, device="cpu")


def _frames_batch(cfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S))}


def _port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else jnp.float32)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


def test_apply_mrope_matches_reference():
    """Distinct temporal, height and width positions, each rotating its own
    section of the frequencies (Qwen2-VL's (16, 24, 24) at d_head 128)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 128)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 5, 3))
    assert len({tuple(p) for p in pos.reshape(-1, 3).T}) == 3
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, (16, 24, 24))
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), 1e6, (16, 24, 24))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="do not sum"):
        layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, (16, 24, 16))


def test_mrope_text_mode_equals_rope():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 7, 4, 16)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 1000, (2, 7)))
    text = layers.text_mrope_positions(pos)
    assert text.shape == (2, 7, 3) and torch.equal(text[..., 2], pos)
    assert torch.equal(layers.apply_mrope(x, text, 1e6, (2, 3, 3)),
                       layers.apply_rope(x, pos, 1e6))


def test_vlm_forward_matches_reference():
    jcfg, jp, cfg, model = _carried(VLM)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    want, _ = JM.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(toks))
        plain_rope = Transformer.from_params(dataclasses.replace(cfg, mrope_sections=None),
                                             model.state_dict(), device="cpu")
        same, _ = plain_rope(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert torch.equal(got, same)  # text mode: M-RoPE is RoPE


def test_vlm_prefill_and_decode_match_reference():
    """Decode's M-RoPE positions are ``pos[:, None]`` in text mode."""
    jcfg, jp, cfg, model = _carried(VLM)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 17))
    jl, jcache = JM.prefill(jp, {"tokens": jnp.asarray(toks[:, :16], jnp.int32)}, jcfg,
                            S_max=18)
    pos = np.full((2,), 16)
    jd, _ = JM.decode_step(jp, jcache, jnp.asarray(toks[:, 16], jnp.int32),
                           jnp.asarray(pos, jnp.int32), jcfg)
    with torch.no_grad():
        tl, cache = model.prefill(torch.from_numpy(toks[:, :16]), S_max=18)
        td, _ = model.decode_step(cache, torch.from_numpy(toks[:, 16]), torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the frames frontend and the non-causal encoder
# ---------------------------------------------------------------------------


def test_encoder_forward_on_frames_matches_reference():
    """Frames (B, S, d_model) projected by ``embed_proj`` (no ``embed``), then
    non-causal attention: a later frame changes an earlier frame's logits."""
    jcfg, jp, cfg, model = _carried(AUDIO)
    assert not cfg.causal and not hasattr(model, "embed")
    batch = _frames_batch(cfg)
    want, _ = JM.forward(jp, {"frames": jnp.asarray(batch["frames"])}, jcfg)
    with torch.no_grad():
        got, aux = model(torch.from_numpy(batch["frames"]))
        by_key, _ = model(_port(batch))  # the reference's batch keys
        frames = torch.from_numpy(batch["frames"]).clone()
        frames[:, -1] += 1.0
        moved, _ = model(frames)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert torch.equal(by_key, got) and float(aux) == 0.0
    assert float((moved[:, 0] - got[:, 0]).abs().max()) > 1e-3


def test_encoder_loss_and_grads_match_reference():
    """The frame-label CE: the batch without ``labels`` as inputs, no shift."""
    jcfg, jp, cfg, model = _carried(AUDIO)
    batch = _frames_batch(cfg)
    jl, jg = jax.value_and_grad(JM.loss_fn)(jp, _jax(batch), jcfg)
    params = dict(model.named_parameters())
    loss = loss_fn(model, _port(batch))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    assert abs(float(loss.detach()) - float(jl)) <= ATOL + RTOL * abs(float(jl))
    want = _unstack(jax.tree.map(np.asarray, jg), cfg)
    assert set(grads) == set(want) and "embed_proj" in grads
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], rtol=RTOL, atol=ATOL, err_msg=name)
    chunked = loss_fn(model, _port(batch), dataclasses.replace(cfg, ce_impl="chunked",
                                                               ce_chunk=24))
    assert abs(float(chunked.detach()) - float(jl)) < 1e-4


def test_encoder_train_steps_match_reference():
    """``tests/test_models.py::test_arch_smoke_train_step`` for HuBERT on both
    packages: two steps on frames and labels, the same losses, falling."""
    jcfg, jp, cfg, model = _carried(AUDIO)
    batch = _frames_batch(cfg)
    kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    jopt, opt = JAdamW(**kw), AdamW(**kw)
    jst = jopt.init(jp)
    st = adamw_state_from_reference(jax.tree.map(np.asarray, jst), cfg)
    jstep = jax.jit(JM.make_train_step(jcfg, jopt))
    step = make_train_step(opt)
    jl, ls = [], []
    for _ in range(2):
        loss, jp, jst = jstep(jp, jst, _jax(batch))
        jl.append(float(loss))
        loss, st = step(model, st, _port(batch))
        ls.append(float(loss))
    np.testing.assert_allclose(ls, jl, rtol=RTOL, atol=ATOL)
    assert np.isfinite(ls).all() and ls[1] < ls[0]


def test_encoder_has_no_serving_path():
    cfg = configs.get_reduced(AUDIO)
    model = Transformer(cfg, device="cpu", seed=0)
    toks = torch.zeros((1, 4), dtype=torch.long)
    for call in (lambda: model.prefill(toks, S_max=8),
                 lambda: model.decode_step([], toks[:, 0], torch.zeros(1, dtype=torch.long)),
                 lambda: model.init_cache(1, 8)):
        with pytest.raises(ValueError, match="encoder-only"):
            call()
    with pytest.raises(ValueError, match="encoder-only"):
        serve_mod.serve(cfg, batch=1, prompt_len=4, gen_tokens=2, device="cpu")


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7)])
def test_frame_embeddings_equal_reference(seed, step):
    got = lm.frame_embeddings(64, 12, 3, seed=seed, step=step, device="cpu")
    want = np.asarray(jlm.frame_embeddings(64, 12, 3, seed=seed, step=step))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# convert and serve for the four new architectures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_adamw_state_carried(arch):
    """``adamw_state_from_reference`` after one reference update (gradients =
    the parameters): fp32 moments unstacked exactly, int8 moments within one
    quantization step of the reference's dequantized values, every
    parameter of the port's model keyed."""
    jcfg = jconfigs.get_reduced(arch)
    cfg = configs.get_reduced(arch)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    names = set(Transformer(cfg, device="meta", seed=None).state_dict())
    for quantize in (False, True):
        jopt = JAdamW(peak_lr=1e-3, warmup_steps=1, total_steps=10, quantize_states=quantize)
        _, jst = jopt.update(jp, jp, jopt.init(jp))
        st = adamw_state_from_reference(jax.tree.map(np.asarray, jst), cfg)
        assert st.step == 1 and set(st.mu) == names == set(st.nu)
        if not quantize:
            want = _unstack(jax.tree.map(np.asarray, jst.mu), cfg)
            for k, v in st.mu.items():
                np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
        else:
            stacked = jax.tree.map(lambda pair, p: np.asarray(jdequantize(*pair, p.shape)),
                                   jst.mu, jp, is_leaf=lambda x: isinstance(x, tuple))
            want = _unstack(stacked, cfg)
            for k, (q, scale) in st.mu.items():
                got = dequantize(q, scale, want[k].shape).numpy()
                step = float(scale.max())  # one quantization step of the re-quantized leaf
                assert np.abs(got - want[k]).max() <= step * (1 + 1e-6), k


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-1.5-large-398b", VLM])
def test_serve_generates_reference_tokens(arch, monkeypatch, capsys):
    """``launch.serve`` through the registry: the reference's greedy tokens
    from the same weights and prompts; the module's command line serves the
    reduced config on the CPU."""
    jcfg = jconfigs.get_reduced(arch)
    want = jserve(jcfg, batch=2, prompt_len=8, gen_tokens=4, seed=0)
    params = lm_params_from_reference(
        jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), jcfg)),
        configs.get_reduced(arch))
    got = serve_mod.serve(configs.get_reduced(arch), batch=2, prompt_len=8, gen_tokens=4,
                          seed=0, params=params, device="cpu")
    np.testing.assert_array_equal(got["generated"], want["generated"])
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, "--reduced", "--device", "cpu",
                                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    serve_mod.main()
    assert "tok/s" in capsys.readouterr().out


def test_train_driver_is_tokens_only():
    """``launch.train`` feeds the token pipeline, as the reference's does; a
    frames encoder trains through ``make_train_step`` (above)."""
    from repro_torch.launch.train import train

    with pytest.raises(ValueError, match="make_train_step"):
        train(configs.get_reduced(AUDIO), steps=1, device="cpu")
