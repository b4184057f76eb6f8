"""Training the port's MoE-family LMs against the JAX package, on the CPU.

DeepSeek-V2-Lite (MLA + MoE) and Kimi-K2 (GQA + MoE) at their reduced
configs, fp32, weights and optimizer state carried from the JAX package with
``convert``. The loss is CE + the summed MoE aux loss, as the reference's.
Held at the LM parity tolerance of ``tests/test_torch_lm.py``, rtol 1e-4 /
atol 1e-5: the loss and every gradient under each remat policy and CE
variant, and the losses of ``make_train_step`` steps after a carried
``AdamWState`` (fp32 and int8 moments; the expert stacks' (n_periods, E, d,
2f) moments included). The remat-full, plain-CE loss and gradients and three
steps from the start are ``tests/test_torch_train.py``'s cases, which cover
every registered arch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.optim import AdamW as JAdamW
from repro_torch import configs
from repro_torch.convert import _unstack, adamw_state_from_reference, lm_params_from_reference
from repro_torch.models.model import Transformer, loss_fn, make_train_step
from repro_torch.optim import AdamW

RTOL, ATOL = 1e-4, 1e-5
MOE_ARCHS = ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b"]


def _carried(arch, seed=0, **replace):
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), **replace)
    cfg = dataclasses.replace(configs.get_reduced(arch), **replace)
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    state = lm_params_from_reference(jax.tree.map(np.asarray, jp), cfg)
    return jcfg, jp, cfg, Transformer.from_params(cfg, state, device="cpu")


def _tokens(cfg, B=2, S=32, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S + 1))


def _loss_and_grads(model, toks, cfg=None):
    params = dict(model.named_parameters())
    loss = loss_fn(model, {"tokens": torch.from_numpy(toks)}, cfg)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


VARIANTS = {"remat-dots": dict(remat=True, remat_policy="dots"),
            "remat-off": dict(remat=False),
            "chunked-ce": dict(ce_impl="chunked", ce_chunk=64)}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_lm_loss_variants_match_reference(arch, variant):
    """The loss (CE + aux) and every gradient under remat ``dots``, remat
    off and the chunked CE, each against the JAX package under the same
    config."""
    jcfg, jp, cfg, model = _carried(arch, **VARIANTS[variant])
    toks = _tokens(cfg)
    jl, jg = jax.value_and_grad(JM.loss_fn)(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg)
    loss, grads = _loss_and_grads(model, toks)
    assert abs(loss - float(jl)) <= ATOL + RTOL * abs(float(jl))
    want = _unstack(jax.tree.map(np.asarray, jg), cfg)
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("quantize", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_optimizer_state_carried_mid_run(arch, quantize):
    """One JAX step, then params and ``AdamWState`` carried across (the
    expert stacks' (n_periods, E, d, 2f) moments included) and two more
    steps in each package: the same losses."""
    jcfg, jp, cfg, _ = _carried(arch)
    toks = _tokens(cfg)
    kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10, quantize_states=quantize)
    jopt, opt = JAdamW(**kw), AdamW(**kw)
    jstep = jax.jit(JM.make_train_step(jcfg, jopt))
    jb = {"tokens": jnp.asarray(toks, jnp.int32)}
    _, jp, jst = jstep(jp, jopt.init(jp), jb)
    model = Transformer.from_params(cfg, lm_params_from_reference(
        jax.tree.map(np.asarray, jp), cfg), device="cpu")
    st_ = adamw_state_from_reference(jax.tree.map(np.asarray, jst), cfg)
    assert st_.step == 1
    leaf = jst.mu["blocks"]["01_moe"]["w_in"]
    if quantize:  # (E, d, 2f) a period is whole 256-value blocks: the same codes
        q, scale = st_.mu["blocks.1.w_in"]
        jq = np.asarray(leaf[0])
        np.testing.assert_array_equal(q.numpy(), jq[:q.shape[0]])
    else:
        np.testing.assert_array_equal(st_.mu["blocks.3.w_in"].numpy(), np.asarray(leaf)[1])
    step = make_train_step(opt)
    for _ in range(2):
        jl, jp, jst = jstep(jp, jst, jb)
        loss, st_ = step(model, st_, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_aux_summed_under_every_remat_policy(arch):
    """The aux loss is carried through each checkpointed period: remat
    ``full``, ``dots`` and off give the same bits of ``hidden``'s aux, and
    the same gradients (a recomputed period repeats the saved one's ops)."""
    cfg = configs.get_reduced(arch)
    model = Transformer(cfg, device="cpu", seed=0)
    toks = torch.from_numpy(_tokens(cfg)[:, :-1])
    auxes, grads = [], []
    for remat, policy in [(True, "full"), (True, "dots"), (False, "full")]:
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        _, aux = model.hidden(toks, cfg=c)
        auxes.append(aux)
        grads.append(torch.autograd.grad(aux, [model.blocks[1].router])[0])
    with torch.no_grad():
        _, aux_plain = model.hidden(toks)
    assert float(auxes[0].detach()) > 0 and torch.equal(aux_plain, auxes[0].detach())
    for a, g in zip(auxes[1:], grads[1:]):
        assert torch.equal(a, auxes[0]) and torch.equal(g, grads[0])
