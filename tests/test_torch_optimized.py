"""The ``get_optimized`` profile's pieces against the JAX package, on the
CPU: chunked attention (GQA and MLA, causal, ragged and non-causal), the
sLSTM's cost form (``unroll_scan``), and the rowwise MoE dispatch under a
mesh.

Weights come from the JAX package's ``init_params`` (carried with
``convert``), inputs from a numpy seed; the reduced configs are fp32.
Tolerances:

* losses within 1e-4 (absolute), of the reference's chunked loss and of the
  port's own default-attention loss (the online softmax sums the same
  terms in another order: fp32 noise, ~1e-6 on a loss of ~5);
* gradients and block outputs at the LM parity tolerance of
  ``tests/test_torch_lm.py``, rtol 1e-4 / atol 1e-5;
* the sLSTM cost form: its log-step scan sums the linear recurrences in
  another order than ``jax.lax.associative_scan``'s tree, so the same
  tolerance as the Mamba scan's parity (``tests/test_torch_ssm.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.convert import _unstack, lm_params_from_reference
from repro_torch.kernels import ops
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import attention, hints, moe
from repro_torch.models.model import Transformer, loss_fn

RTOL, ATOL = 1e-4, 1e-5
LOSS_TOL = 1e-4
S = 64

# (arch, attn_chunk): chunks of 16 over S = 64; 24 leaves Sk ragged (64 % 24),
# which both packages send to their default attention
CHUNKED = {
    "qwen3-8b": ("qwen3-8b", 16),
    "deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", 16),
    "qwen3-8b-ragged": ("qwen3-8b", 24),
    "hubert-xlarge-noncausal": ("hubert-xlarge", 16),
}


def _carried(arch, **kw):
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), **kw)
    cfg = dataclasses.replace(configs.get_reduced(arch), **kw)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    state = lm_params_from_reference(jax.tree.map(np.asarray, jp), cfg)
    return jcfg, jp, cfg, Transformer.from_params(cfg, state, device="cpu")


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "tokens":
        return {"tokens": rng.integers(0, cfg.vocab_size, (2, S + 1))}
    return {"frames": rng.standard_normal((2, S, cfg.d_model)).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size, (2, S))}


def _port_loss_and_grads(model, batch, cfg=None):
    params = dict(model.named_parameters())
    loss = loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


@pytest.mark.parametrize("case", sorted(CHUNKED))
def test_chunked_loss_and_grads_match_reference(case):
    arch, chunk = CHUNKED[case]
    jcfg, jp, cfg, model = _carried(arch, attn_impl="chunked", attn_chunk=chunk)
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.jit(jax.value_and_grad(JM.loss_fn), static_argnums=2)(jp, jbatch, jcfg)
    loss, grads = _port_loss_and_grads(model, batch)
    assert abs(loss - float(jl)) <= LOSS_TOL
    default = Transformer.from_params(dataclasses.replace(cfg, attn_impl="reference"),
                                      model.state_dict(), device="cpu")
    plain, _ = _port_loss_and_grads(default, batch)
    assert abs(loss - plain) <= LOSS_TOL
    want = _unstack(jax.tree.map(np.asarray, jg), cfg)
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("group", [1, 4], ids=["mha", "gqa4"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_chunked_attention_matches_plain_attention(causal, group):
    """The online softmax against one softmax over all keys, dv != d; the
    ragged length falls back to ``ops.multihead_attention`` itself."""
    rng = np.random.default_rng(3)
    B, Hkv, dh, dv = 2, 2, 24, 16
    q = torch.from_numpy(rng.standard_normal((B, Hkv * group, 48, dh)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, Hkv, 48, dh)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, Hkv, 48, dv)).astype(np.float32))
    want = ops.multihead_attention(q, k, v, causal=causal)
    for chunk in (8, 16, 48, 100):
        dims = attention.AttnDims(Hkv * group, Hkv, dh, False, False, 1e4, causal,
                                  impl="chunked", chunk=chunk)
        got = attention.attend(q, k, v, dims, None)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    ragged = attention.AttnDims(Hkv * group, Hkv, dh, False, False, 1e4, causal,
                                impl="chunked", chunk=20)
    assert torch.equal(attention.attend(q, k, v, ragged, None), want)


def test_slstm_cost_mode_matches_reference():
    """xLSTM with ``unroll_scan`` (the dry run's config): its sLSTM blocks
    run the reference's FLOP-equivalent parallel form; the logits match the
    reference's ``cost_mode`` and differ from the time loop's."""
    jcfg, jp, cfg, model = _carried("xlstm-1.3b", unroll_scan=True)
    assert all(b.cost_mode for b in model.blocks if type(b).__name__ == "SLSTM")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32))
    want, _ = jax.jit(JM.forward, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(toks))
        loop = Transformer.from_params(dataclasses.replace(cfg, unroll_scan=False),
                                       model.state_dict(), device="cpu")(torch.from_numpy(toks))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert float((got - loop).abs().max()) > 1e-3  # a cost proxy, not the sLSTM's values


def _moe_pair(capacity_factor, seed=0, d=64, E=8, k=2, f=32):
    kw = dict(num_experts=E, top_k=k, d_ff=f, n_shared=1, capacity_factor=capacity_factor)
    jdims = jmoe.MoEDims(**kw)
    jp = jmoe.init_params(jax.random.PRNGKey(seed), d, jdims, jnp.float32)
    block = moe.MoE(d, moe.MoEDims(**kw, dispatch="rowwise"), torch.float32, "cpu")
    block.load_state_dict({n: torch.from_numpy(np.array(v)) for n, v in jp.items()})
    return jdims, jp, block


@pytest.mark.parametrize("capacity_factor", [1.0, 0.0], ids=["capacity", "dropless"])
def test_rowwise_moe_two_rows_matches_reference_per_row(capacity_factor):
    """Under an abstract (data=2, model=1) mesh the rowwise dispatch routes,
    dispatches and combines each row at capacity(T / 2): each row's output
    is the reference's global forward on that row's sub-batch, and the aux
    loss is the reference's formula over all the tokens (its global
    forward on the whole batch)."""
    jdims, jp, block = _moe_pair(capacity_factor)
    x = np.random.default_rng(5).standard_normal((2, 32, 64)).astype(np.float32)
    with torch.no_grad(), hints.use_mesh(AbstractMesh((2, 1), ("data", "model"))):
        assert moe.rows_of(64, block.dims) == 2
        out, aux = block(torch.from_numpy(x))
    jforward = jax.jit(jmoe.forward, static_argnums=2)
    for r in range(2):
        want, _ = jforward(jp, jnp.asarray(x[r:r + 1]), jdims)
        np.testing.assert_allclose(out[r:r + 1].numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    _, jaux = jforward(jp, jnp.asarray(x), jdims)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL, atol=ATOL)
    if capacity_factor:  # the rows' capacity differs from the global one's
        whole, _ = block(torch.from_numpy(x))
        assert not torch.equal(whole, out)


def test_rowwise_moe_one_row_keeps_global_bits():
    """Without a mesh, or where the rows do not divide the tokens, rowwise
    is the global dispatch: the same bits."""
    _, _, block = _moe_pair(1.25)
    glob = moe.MoE(64, block.dims._replace(dispatch="global"), torch.float32, "cpu")
    glob.load_state_dict(block.state_dict())
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 7, 64)).astype(np.float32))
    with torch.no_grad():
        want = glob(x)
        for mesh in (None, AbstractMesh((2, 1), ("data", "model"))):  # 21 tokens: one row
            with hints.use_mesh(mesh):
                got = block(x)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
