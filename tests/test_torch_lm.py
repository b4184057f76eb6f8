"""The port's dense LM serving path against the JAX package's, on the CPU.

The JAX package's random parameters are carried into the port with
``convert.lm_params_from_reference``; both packages then get the same tokens.
fp32 reduced configs are held at rtol 1e-4 / atol 1e-5 (the same products
summed in another order); the port's own prefill + decode against its
forward at ``tests/test_models.py``'s 5e-3.  The ``gpu``-marked test runs the
model on the card with and without its kernel.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.serve import serve as jserve
from repro.models import layers as jlayers
from repro.models import model as JM
from repro_torch import configs
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels import ops
from repro_torch.launch.serve import serve
from repro_torch.models import layers
from repro_torch.models.model import ModelConfig, Transformer

DENSE = sorted(configs.ARCHS)
PARITY = ["qwen3-8b", "qwen2-1.5b"]
RTOL, ATOL = 1e-4, 1e-5
DECODE_TOL = 5e-3  # tests/test_models.py: prefill + decode == forward


def _reference(arch, seed=0, dtype=None):
    """(JAX config, JAX params, the port's model holding the same params)."""
    jcfg = jconfigs.get_reduced(arch)
    cfg = configs.get_reduced(arch)
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        cfg = dataclasses.replace(cfg, dtype=dtype)
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    state = lm_params_from_reference(jax.tree.map(np.asarray, jp), cfg)
    return jcfg, jp, Transformer.from_params(cfg, state, device="cpu")


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("which", ["config", "reduced"])
def test_configs_copied_exactly(arch, which):
    getter = "get_reduced" if which == "reduced" else "get_config"
    got = getattr(configs, getter)(arch)
    want = getattr(jconfigs, getter)(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("arch", sorted(configs.UNPORTED))
def test_unported_archs_raise(arch):
    assert arch in jconfigs.ARCHS
    with pytest.raises(NotImplementedError, match="item 14"):
        configs.get_reduced(arch)
    jcfg = jconfigs.get_reduced(arch)
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    with pytest.raises(NotImplementedError, match="item 14"):
        Transformer(cfg, device="cpu")


def test_unported_options_raise():
    cfg = configs.get_reduced("qwen3-8b")
    with pytest.raises(NotImplementedError, match="item 14h"):
        Transformer(dataclasses.replace(cfg, attn_impl="chunked"), device="cpu")
    with pytest.raises(NotImplementedError, match="item 14f"):
        Transformer(dataclasses.replace(cfg, mrope_sections=(2, 3, 3)), device="cpu")


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = rng.integers(0, 1000, (2, 5))
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale))), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        rtol=RTOL, atol=ATOL)
    h = rng.standard_normal((4, 8)).astype(np.float32)
    w_in = rng.standard_normal((8, 12)).astype(np.float32)
    w_out = rng.standard_normal((6, 8)).astype(np.float32)
    w_g = rng.standard_normal((12, 8)).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(
        layers.swiglu(t(h), t(w_in), t(w_out)).numpy(),
        np.asarray(jlayers.swiglu(jnp.asarray(h), jnp.asarray(w_in), jnp.asarray(w_out))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        layers.gelu_mlp(t(h), t(w_in), t(w_g)).numpy(),
        np.asarray(jlayers.gelu_mlp(jnp.asarray(h), jnp.asarray(w_in), jnp.asarray(w_g))),
        rtol=RTOL, atol=ATOL)


def test_initializers():
    gen = torch.Generator().manual_seed(0)
    w = layers.dense_init(gen, (256, 512), torch.float32, "cpu")
    std = 1.0 / 256 ** 0.5
    assert float(w.abs().max()) <= 2 * std
    assert abs(float(w.std()) / std - 0.88) < 0.02  # std of N(0,1) cut at +-2
    e = layers.embed_init(gen, (512, 256), torch.bfloat16, "cpu")
    assert e.dtype == torch.bfloat16 and abs(float(e.float().std()) - 0.02) < 1e-3
    cfg = configs.get_reduced("qwen3-8b")
    a, b = Transformer(cfg, device="cpu", seed=3), Transformer(cfg, device="cpu", seed=3)
    c = Transformer(cfg, device="cpu", seed=4)
    for (name, pa), pb, pc in zip(a.state_dict().items(), b.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(pa, pb), name
        if name.endswith(("wq", "w_in", "embed", "head")):
            assert not torch.equal(pa, pc), name


@pytest.mark.parametrize("arch", PARITY)
def test_forward_matches_reference(arch):
    jcfg, jp, model = _reference(arch)
    toks = _tokens(jcfg, (2, 16))
    want, _ = JM.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg)
    with torch.no_grad():
        got, aux = model(torch.from_numpy(toks))
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", PARITY)
def test_prefill_and_decode_match_reference(arch):
    jcfg, jp, model = _reference(arch)
    toks = _tokens(jcfg, (2, 17))
    jl, jcache = JM.prefill(jp, {"tokens": jnp.asarray(toks[:, :16], jnp.int32)}, jcfg,
                            S_max=18)
    pos = np.full((2,), 16)
    jd, jcache2 = JM.decode_step(jp, jcache, jnp.asarray(toks[:, 16], jnp.int32),
                                 jnp.asarray(pos, jnp.int32), jcfg)
    with torch.no_grad():
        tl, cache = model.prefill(torch.from_numpy(toks[:, :16]), S_max=18)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
        td, cache = model.decode_step(cache, torch.from_numpy(toks[:, 16]),
                                      torch.from_numpy(pos))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)
    # the in-place cache write gives the JAX package's one-hot-added cache
    jk = np.asarray(jcache2["00_attn"].k)
    for i in range(jcfg.n_periods):
        np.testing.assert_allclose(cache[2 * i].k.numpy(), jk[i], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_matches_forward(arch):
    """prefill(P) + decode(t) logits == forward(P + t) next-token logits."""
    cfg = configs.get_reduced(arch)
    model = Transformer(cfg, device="cpu", seed=1)
    toks = torch.from_numpy(_tokens(cfg, (2, 17)))
    with torch.no_grad():
        lf, cache = model.prefill(toks[:, :16], S_max=18)
        full16, _ = model(toks[:, :16])
        torch.testing.assert_close(lf[:, 0], full16[:, -1], rtol=DECODE_TOL, atol=DECODE_TOL)
        ld, _ = model.decode_step(cache, toks[:, 16], torch.full((2,), 16))
        full17, _ = model(toks)
    torch.testing.assert_close(ld[:, 0], full17[:, -1], rtol=DECODE_TOL, atol=DECODE_TOL)


def test_decode_from_empty_cache_matches_forward():
    """Token-by-token decode from ``init_cache`` gives forward's logits."""
    cfg = configs.get_reduced("qwen2-1.5b")
    model = Transformer(cfg, device="cpu", seed=2)
    toks = torch.from_numpy(_tokens(cfg, (2, 9)))
    with torch.no_grad():
        full, _ = model(toks)
        cache = model.init_cache(2, S_max=9)
        steps = [model.decode_step(cache, toks[:, t], torch.full((2,), t))[0][:, 0]
                 for t in range(9)]
    torch.testing.assert_close(torch.stack(steps, dim=1), full, rtol=DECODE_TOL,
                               atol=DECODE_TOL)


def test_serve_sampling_is_seeded():
    cfg = configs.get_reduced("qwen3-8b")
    kw = dict(batch=2, prompt_len=8, gen_tokens=6, greedy=False, device="cpu")
    a, b = serve(cfg, seed=5, **kw), serve(cfg, seed=5, **kw)
    np.testing.assert_array_equal(a["generated"], b["generated"])
    assert ((a["generated"] >= 0) & (a["generated"] < cfg.vocab_size)).all()


@pytest.mark.parametrize("arch", PARITY)
def test_serve_generates_reference_tokens(arch):
    jcfg = jconfigs.get_reduced(arch)
    want = jserve(jcfg, batch=2, prompt_len=8, gen_tokens=6, seed=0)
    params = lm_params_from_reference(
        jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), jcfg)),
        configs.get_reduced(arch))
    got = serve(configs.get_reduced(arch), batch=2, prompt_len=8, gen_tokens=6, seed=0,
                params=params, device="cpu")
    assert got["generated"].shape == (2, 6)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert got["prefill_s"] > 0 and got["tokens_per_s"] > 0


def test_convert_carries_bf16_bits():
    jcfg, jp, model = _reference("qwen3-8b", dtype="bfloat16")
    assert model.embed.dtype == torch.bfloat16
    want = np.asarray(jp["blocks"]["01_mlp"]["w_in"][1].astype(jnp.float32))
    np.testing.assert_array_equal(model.blocks[3].w_in.float().numpy(), want)


def test_serve_without_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve(configs.get_reduced("qwen3-8b"), batch=1, prompt_len=4, gen_tokens=2)


@pytest.mark.gpu
@pytest.mark.parametrize("d_head", [16, 128])  # the scalar and the wgmma variant
def test_model_on_card_kernel_vs_plain(monkeypatch, d_head):
    """A bf16 reduced model on the card: one flash launch per attention layer
    in prefill, and logits no further from an fp32 copy of the model than
    twice the plain-attention bf16 model's (the two bf16 models differ only
    in attention's roundings; chip_smoke.py holds Qwen3-8B to the same rule).
    """
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(configs.get_reduced("qwen3-8b"), dtype="bfloat16",
                              d_head=d_head)
    model = Transformer(cfg, device="cuda", seed=0)
    model32 = Transformer.from_params(dataclasses.replace(cfg, dtype="float32"),
                                      model.state_dict(), device="cuda")
    toks = torch.from_numpy(_tokens(cfg, (2, 64))).cuda()
    with torch.no_grad():
        ops.reset_launch_counts()
        got, _ = model.prefill(toks, S_max=70)
        assert ops.launch_counts()["flash_attention"] == cfg.n_periods
        plain, _ = model.prefill(toks, S_max=70, use_kernel=False)
        want, _ = model32.prefill(toks, S_max=70, use_kernel=False)
    err_kernel = float((got.float() - want).abs().max())
    err_plain = float((plain.float() - want).abs().max())
    assert err_kernel <= 2 * err_plain, (err_kernel, err_plain)
