"""The port's LM training step against the JAX package's, on the CPU.

The JAX package's random parameters (and optimizer state) are carried into
the port with ``convert``; both packages then get the same numpy-seeded
tokens.  Reduced configs are fp32, so the port is held to the JAX package
at the LM parity tolerance of ``tests/test_torch_lm.py``, rtol 1e-4 /
atol 1e-5 (the same products summed in another order): the loss, every
gradient (mapped through ``convert``'s unstacking), each loss of three
``make_train_step`` steps on one batch, and the parameters after them
(all but 0.1% of entries, which Adam's normalization may move by up to its
step size, 3 lr over three steps).
Inside the port: the reference's own variant checks
(``tests/test_perf_variants.py``) -- chunked CE against plain at its
tolerances (1e-4 on the loss; rtol 2e-3 / atol 2e-4 on gradients) and the
remat policies at 1e-5 -- plus the remat contract that a recomputed period
gives the same gradient bits as a saved one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.models import model as JM
from repro.optim import AdamW as JAdamW
from repro_torch import configs
from repro_torch.convert import _unstack, adamw_state_from_reference, lm_params_from_reference
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops, ref
from repro_torch.models.model import Transformer, loss_fn, make_train_step
from repro_torch.optim import AdamW

# the token archs without recurrent blocks; tests/test_torch_ssm.py and
# tests/test_torch_families.py train the SSM archs and the frames encoder
DENSE = sorted(a for a in configs.ARCHS
               if configs.get_reduced(a).frontend == "tokens"
               and not set(configs.get_reduced(a).period) & {"mamba", "mlstm", "slstm"})
RTOL, ATOL = 1e-4, 1e-5
VARIANTS = {"chunked-ce": dict(ce_impl="chunked", ce_chunk=64),
            "remat-dots": dict(remat=True, remat_policy="dots"),
            "remat-off": dict(remat=False)}


def _carried(arch, seed=0):
    """(JAX config, JAX params, the port's config, model with those params)."""
    jcfg, cfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    state = lm_params_from_reference(jax.tree.map(np.asarray, jp), cfg)
    return jcfg, jp, cfg, Transformer.from_params(cfg, state, device="cpu")


def _tokens(cfg, B=2, S=32, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S + 1))


def _port_loss_and_grads(model, toks, cfg=None):
    params = dict(model.named_parameters())
    loss = loss_fn(model, {"tokens": torch.from_numpy(toks)}, cfg)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def _assert_grads_match(grads, jgrads, cfg):
    want = _unstack(jax.tree.map(np.asarray, jgrads), cfg)
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_reference(arch):
    """Every dense arch at its reduced config (plain CE, remat full)."""
    jcfg, jp, cfg, model = _carried(arch)
    toks = _tokens(cfg)
    jl, jg = jax.value_and_grad(JM.loss_fn)(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg)
    loss, grads = _port_loss_and_grads(model, toks)
    assert abs(loss - float(jl)) <= ATOL + RTOL * abs(float(jl))
    _assert_grads_match(grads, jg, cfg)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_variants_match_reference(variant):
    """Chunked CE (``ce_chunk=64``), remat ``dots`` and remat off, each
    against the JAX package under the same config."""
    jcfg, jp, cfg, model = _carried("qwen3-8b")
    jcfg = dataclasses.replace(jcfg, **VARIANTS[variant])
    cfg = dataclasses.replace(cfg, **VARIANTS[variant])
    toks = _tokens(cfg)
    jl, jg = jax.value_and_grad(JM.loss_fn)(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg)
    loss, grads = _port_loss_and_grads(model, toks, cfg)
    assert abs(loss - float(jl)) <= ATOL + RTOL * abs(float(jl))
    _assert_grads_match(grads, jg, cfg)


def test_chunked_ce_equals_plain():
    """``tests/test_perf_variants.py::test_chunked_ce_equals_plain`` on the
    port, with a vocabulary that is not a multiple of the chunk."""
    cfg = configs.get_reduced("qwen3-8b")
    model = Transformer(cfg, device="cpu", seed=0)
    toks = _tokens(cfg)
    plain, g1 = _port_loss_and_grads(model, toks)
    for chunk in (64, 100):
        chunked, g2 = _port_loss_and_grads(
            model, toks, dataclasses.replace(cfg, ce_impl="chunked", ce_chunk=chunk))
        assert abs(plain - chunked) < 1e-4
        for name in g1:
            torch.testing.assert_close(g2[name], g1[name], rtol=2e-3, atol=2e-4)


class _Shapes(TorchDispatchMode):
    """Records the shape of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if torch.is_tensor(t):
                self.shapes.add(tuple(t.shape))
        return out


@pytest.mark.parametrize("ce_impl", ["plain", "chunked"])
def test_chunked_ce_makes_no_full_logits(ce_impl):
    """The chunked CE's forward makes no (B, S, V) tensor; the plain one does."""
    # a vocabulary no other dimension of the model shares
    cfg = dataclasses.replace(configs.get_reduced("qwen2-1.5b"), vocab_size=300,
                              ce_impl=ce_impl, ce_chunk=64)
    model = Transformer(cfg, device="cpu", seed=0)
    toks = torch.from_numpy(_tokens(cfg, B=2, S=16))
    with _Shapes() as mode:
        loss_fn(model, {"tokens": toks})
    assert ((2, 16, cfg.vocab_size) in mode.shapes) == (ce_impl == "plain")
    if ce_impl == "chunked":
        assert (2, 16, 64) in mode.shapes


def test_remat_policies_same_loss_and_bits():
    """``tests/test_perf_variants.py::test_remat_policies_same_loss_different_none``
    on the port (losses within 1e-5, gradients finite); a recomputed period
    repeats the saved one's ops, so the gradients are the same bits."""
    cfg = configs.get_reduced("qwen3-8b")
    model = Transformer(cfg, device="cpu", seed=0)
    toks = _tokens(cfg)
    losses, grads = [], []
    for remat, policy in [(True, "full"), (True, "dots"), (False, "full")]:
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        loss, g = _port_loss_and_grads(model, toks, c)
        losses.append(loss)
        grads.append(g)
        assert all(bool(torch.isfinite(x).all()) for x in g.values())
    assert max(losses) - min(losses) < 1e-5
    for g in grads[1:]:
        assert all(torch.equal(g[k], grads[0][k]) for k in g)
    with pytest.raises(ValueError, match="remat_policy"):
        _port_loss_and_grads(model, toks, dataclasses.replace(cfg, remat_policy="nope"))


@pytest.mark.parametrize("arch", DENSE)
def test_train_steps_match_reference(arch):
    """``tests/test_models.py::test_arch_smoke_train_step`` on both packages
    from the same params and optimizer state: three steps on one batch, the
    losses equal at each step and descending (``l2 < l0``), the parameters
    after them allclose."""
    jcfg, jp, cfg, model = _carried(arch)
    toks = _tokens(cfg)
    jopt = JAdamW(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    opt = AdamW(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    jst = jopt.init(jp)
    st = adamw_state_from_reference(jax.tree.map(np.asarray, jst), cfg)
    jstep = jax.jit(JM.make_train_step(jcfg, jopt))
    step = make_train_step(opt)
    jb, b = {"tokens": jnp.asarray(toks, jnp.int32)}, {"tokens": torch.from_numpy(toks)}
    jl, ls = [], []
    for _ in range(3):
        loss, jp, jst = jstep(jp, jst, jb)
        jl.append(float(loss))
        loss, st = step(model, st, b)
        assert loss.grad_fn is None
        ls.append(float(loss))
    np.testing.assert_allclose(ls, jl, rtol=RTOL, atol=ATOL)
    assert ls[2] < ls[0] and np.isfinite(ls).all()
    assert st.step == 3
    # Adam divides by sqrt(nu) + 1e-8, so a gradient entry near 1e-8 moves
    # its weight by up to lr a step whatever its rounding (the key bias's
    # gradient is 0 up to rounding: softmax ignores a shift of every key):
    # such entries may differ by up to 3 lr; all but 0.1% of the entries
    # are within rtol / atol
    want = _unstack(jax.tree.map(np.asarray, jp), cfg)
    off = total = 0
    for name, p in model.named_parameters():
        got, w = p.detach().numpy(), want[name]
        diff = np.abs(got - w)
        assert diff.max() <= 3 * opt.peak_lr, name
        off += int(np.sum(diff > ATOL + RTOL * np.abs(w)))
        total += w.size
    assert off <= 1e-3 * total, (off, total)


@pytest.mark.parametrize("quantize", [False, True], ids=["fp32", "int8"])
def test_optimizer_state_carried_mid_run(quantize):
    """One JAX step, then params and ``AdamWState`` carried across
    (``adamw_state_from_reference``) and two more steps in each package:
    the same losses.  The reduced configs' weight matrices are whole
    256-value blocks a period, so their int8 codes carry over exactly."""
    jcfg, jp, cfg, _ = _carried("qwen2-1.5b")
    toks = _tokens(cfg)
    kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10, quantize_states=quantize)
    jopt, opt = JAdamW(**kw), AdamW(**kw)
    jstep = jax.jit(JM.make_train_step(jcfg, jopt))
    jb = {"tokens": jnp.asarray(toks, jnp.int32)}
    _, jp, jst = jstep(jp, jopt.init(jp), jb)
    model = Transformer.from_params(cfg, lm_params_from_reference(
        jax.tree.map(np.asarray, jp), cfg), device="cpu")
    st = adamw_state_from_reference(jax.tree.map(np.asarray, jst), cfg)
    assert st.step == 1
    if quantize:
        q, scale = st.mu["blocks.0.wq"]
        jq = np.asarray(jst.mu["blocks"]["00_attn"]["wq"][0])
        n = q.shape[0]
        assert np.array_equal(q.numpy(), jq[:n]) and scale.shape == (n, 1)
    step = make_train_step(opt)
    for _ in range(2):
        jl, jp, jst = jstep(jp, jst, jb)
        loss, st = step(model, st, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL, atol=ATOL)


def test_flash_autograd_function_gradient(monkeypatch):
    """``FlashAttention``'s wiring, with the kernel's plain version in its
    place (the kernel itself runs only on the card): its output has a
    ``grad_fn``, and its backward (the plain version's vector-Jacobian
    product) gives autograd's gradients through the plain version, bit for
    bit, for the inputs that need them."""
    monkeypatch.setattr(flash_mod, "flash_attention", ref.attention_ref)
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((6, 20, 16), (3, 20, 16), (3, 20, 8)))
    g = torch.from_numpy(rng.standard_normal((6, 20, 8)).astype(np.float32))
    for need in ((True, True, True), (False, True, False)):
        a = [t.clone().requires_grad_(n) for t, n in zip((q, k, v), need)]
        b = [t.clone().requires_grad_(n) for t, n in zip((q, k, v), need)]
        out = flash_mod.FlashAttention.apply(*a, True, 2)
        assert out.grad_fn is not None
        out.backward(g)
        ref.attention_ref(*b, causal=True, q_heads_per_kv=2).backward(g)
        for x, y, n in zip(a, b, need):
            assert (x.grad is None) == (not n)
            if n:
                assert torch.equal(x.grad, y.grad)


def test_attention_dispatch_keeps_cpu_on_plain():
    """On the CPU ``multihead_attention`` stays on the plain version with
    gradients (autograd through it), and ``use_kernel=True`` raises there."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((1, 4, 8, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 8, 16)).astype(np.float32))
    q.requires_grad_(True)
    out = ops.multihead_attention(q, k, k, causal=True)
    assert out.grad_fn is not None and "FlashAttention" not in type(out.grad_fn).__name__
    out.sum().backward()
    assert q.grad is not None
    with pytest.raises(ValueError, match="CUDA"):
        ops.multihead_attention(q, k, k, use_kernel=True)
