"""The port's MoE block and MoE-family LMs against the JAX package, on the CPU.

Weights come from the JAX package's ``init_params`` (carried with
``convert``), inputs from a numpy seed; everything is fp32. Expert ids are
held equal exactly (recorded from ``jax.lax.top_k`` inside the reference's
forward and from ``moe.route`` inside the port's), full ties included; the
outputs, aux losses, logits, losses and gradients at the LM parity tolerance
of ``tests/test_torch_lm.py``, rtol 1e-4 / atol 1e-5 (the same products
summed in another order); decode against forward at
``tests/test_models.py``'s 5e-3. The reference's property tests
(``tests/test_moe_props.py``) are repeated on the port, and the dispatch is
held to the same bits twice, no read back to the host and no float
scatter-add.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.launch.serve import serve as jserve
from repro.models import model as JM
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch.serve import serve
from repro_torch.models import moe
from repro_torch.models.model import Transformer, loss_fn

from _torch_moe_routes import routes

RTOL, ATOL = 1e-4, 1e-5
DECODE_TOL = 5e-3  # tests/test_models.py: prefill + decode == forward
MOE_ARCHS = ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b"]


def _dims(module, E, k, f, **kw):
    return module.MoEDims(num_experts=E, top_k=k, d_ff=f, **kw)


def _carried_block(E, k, d, f, T, seed, **kw):
    """(JAX dims, JAX params, x (numpy), the port's block holding those params)."""
    jdims = _dims(jmoe, E, k, f, **kw)
    jp = jmoe.init_params(jax.random.PRNGKey(seed), d, jdims, jnp.float32)
    block = moe.MoE(d, _dims(moe, E, k, f, **kw), torch.float32, "cpu")
    block.load_state_dict({n: torch.from_numpy(np.array(v)) for n, v in jp.items()})
    x = np.random.default_rng(seed).standard_normal((2, T // 2, d)).astype(np.float32)
    return jdims, jp, x, block


def _reference_ids(monkeypatch, fn):
    """Run ``fn`` with ``jax.lax.top_k`` recorded; returns (fn's result, the
    expert ids of each top-k call, in order: an ordered callback, so calls
    inside ``jit`` and the period scan are recorded as they run)."""
    seen, top_k = [], jax.lax.top_k

    def recording(x, k):
        vals, idx = top_k(x, k)
        jax.debug.callback(lambda i: seen.append(np.asarray(i)), idx, ordered=True)
        return vals, idx

    monkeypatch.setattr(jax.lax, "top_k", recording)
    out = fn()
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    return out, seen


def _port_ids(monkeypatch, fn):
    """Run ``fn`` with the port's ``moe.route`` recorded."""
    with routes(monkeypatch, []) as ids:
        out = fn()
    return out, [eidx.numpy() for eidx in ids]


def _check_block(monkeypatch, jdims, jp, x, block):
    (want, jaux), jids = _reference_ids(
        monkeypatch, lambda: jax.jit(lambda p, x: jmoe.forward(p, x, jdims))(jp, jnp.asarray(x)))
    with torch.no_grad():
        (got, aux), ids = _port_ids(monkeypatch, lambda: block(torch.from_numpy(x)))
    assert len(ids) == len(jids) == 1
    np.testing.assert_array_equal(ids[0].reshape(jids[0].shape), jids[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL, atol=ATOL)
    return ids[0]


@pytest.mark.parametrize("E,k,n_shared,cf", [
    (8, 2, 0, 1.25),   # the default capacity
    (4, 2, 1, 0.05),   # a tight capacity: most pairs dropped
    (8, 2, 2, 0.0),    # dropless, two shared experts (the reduced configs)
    (16, 4, 1, 1.0),
])
def test_moe_forward_matches_reference(monkeypatch, E, k, n_shared, cf):
    jdims, jp, x, block = _carried_block(E, k, 16, 32, 64, seed=E + k, n_shared=n_shared,
                                         capacity_factor=cf)
    _check_block(monkeypatch, jdims, jp, x, block)


@pytest.mark.parametrize("cf", [1.25, 0.0])
def test_moe_zero_router_ties_match_reference(monkeypatch, cf):
    """A zero router gives every expert the same probability: ``jax.lax.top_k``
    takes the lowest ids, and so must the port (``torch.topk`` promises no
    order among ties).  At the default capacity the first k experts then
    overflow and most pairs are dropped."""
    jdims, jp, x, block = _carried_block(8, 3, 16, 32, 64, seed=5, n_shared=1,
                                         capacity_factor=cf)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    with torch.no_grad():
        block.router.zero_()
    ids = _check_block(monkeypatch, jdims, jp, x, block)
    np.testing.assert_array_equal(ids, np.broadcast_to(np.arange(3), ids.shape))


def test_top_k_ties_to_lower_index():
    probs = torch.tensor([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = moe.top_k(probs, 3)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_capacity_copied_exactly():
    for E, k in ((4, 1), (8, 2), (64, 6), (384, 8)):
        for cf in (0.0, -1.0, 0.05, 1.0, 1.25):
            for T in (1, 4, 7, 64, 100, 8192):
                assert moe.capacity(T, _dims(moe, E, k, 8, capacity_factor=cf)) == \
                    jmoe.capacity(T, _dims(jmoe, E, k, 8, capacity_factor=cf))
    assert moe.MoEDims._fields == jmoe.MoEDims._fields
    assert moe.MoEDims._field_defaults == jmoe.MoEDims._field_defaults


def test_dispatch_plan_keeps_unique_slots():
    """The reference's capacity rule: each expert keeps its first C pairs in
    (token, choice) order, at positions 0, 1, ... of its rows; kept slots
    are distinct, dropped pairs point at the drop row E*C, and the buffer's
    rows name their source tokens (T for an empty row)."""
    rng = np.random.default_rng(0)
    E, k, T, C = 8, 2, 40, 8
    eidx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)])
    plan = moe.dispatch_plan(torch.from_numpy(eidx), E, C)
    want_slot = np.full((T, k), E * C)
    want_src = np.full(E * C, T)
    filled = np.zeros(E, int)
    for t in range(T):
        for j in range(k):
            e = eidx[t, j]
            if filled[e] < C:
                want_slot[t, j] = e * C + filled[e]
                want_src[e * C + filled[e]] = t
            filled[e] += 1
    np.testing.assert_array_equal(plan.slot.numpy(), want_slot)
    np.testing.assert_array_equal(plan.keep.numpy(), want_slot < E * C)
    np.testing.assert_array_equal(plan.src.numpy(), want_src)
    assert filled.max() > C  # some pairs were dropped


_ADDS = {torch.ops.aten.scatter_add.default, torch.ops.aten.scatter_add_.default,
         torch.ops.aten.index_add.default, torch.ops.aten.index_add_.default,
         torch.ops.aten.scatter_reduce.two, torch.ops.aten.scatter_reduce_.two}
_INDEX = {torch.ops.aten.index.Tensor, torch.ops.aten.index_put.default,
          torch.ops.aten.index_put_.default}


class _Ops(TorchDispatchMode):
    """Records every op, the type each scatter-add adds in, and every index
    op that takes a boolean mask or accumulates."""

    def __init__(self):
        super().__init__()
        self.ops, self.add_types, self.masked = set(), set(), []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.add(func)
        if func in _ADDS:
            self.add_types.add(args[0].dtype)
        if func in _INDEX:
            if any(t is not None and t.dtype == torch.bool for t in args[1]):
                self.masked.append(func)
            if func is not torch.ops.aten.index.Tensor and (args[3:4] or [False])[0]:
                self.add_types.add(args[0].dtype)
        return func(*args, **(kwargs or {}))


def test_dispatch_same_bits_and_no_host_read():
    """Two calls give the same bits; the forward uses no op that reads a
    value back to the host (``.item()``, ``nonzero``, ``bincount``, masked
    indexing) and adds no floats by scatter (atomic on the card): its only
    scatter-add counts experts in int64."""
    _, _, x, block = _carried_block(8, 2, 16, 32, 64, seed=3, n_shared=1)
    x = torch.from_numpy(x)
    with torch.no_grad():
        a, aux_a = block(x)
        with _Ops() as mode:
            b, aux_b = block(x)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    aten = torch.ops.aten
    banned = {aten._local_scalar_dense.default, aten.nonzero.default, aten.bincount.default,
              aten.masked_select.default, aten.unique_consecutive.default,
              aten._unique2.default}
    assert not (mode.ops & banned), mode.ops & banned
    assert not mode.masked
    assert mode.add_types == {torch.int64}


# ---------------------------------------------------------------------------
# tests/test_moe_props.py on the port (its own seeded init)
# ---------------------------------------------------------------------------


def _block_and_input(E, k, d, f, T, seed, n_shared=0, dispatch="global"):
    dims = _dims(moe, E, k, f, n_shared=n_shared, dispatch=dispatch)
    block = moe.MoE(d, dims, torch.float32, "cpu", torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, T // 2, d)).astype(np.float32))
    return dims, block, x


def _run(block, x, **weights):
    """The block's forward with some weights replaced."""
    saved = {n: getattr(block, n).detach().clone() for n in weights}
    with torch.no_grad():
        for n, w in weights.items():
            getattr(block, n).copy_(w)
        out = block(x)
        for n, w in saved.items():
            getattr(block, n).copy_(w)
    return out


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 1000), st.sampled_from([4, 8]), st.sampled_from([1, 2]))
def test_moe_output_finite_and_residual(seed, E, k):
    _, block, x = _block_and_input(E, k, 16, 32, 16, seed)
    out, aux = _run(block, x)
    assert out.shape == x.shape
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(aux))
    out0, _ = _run(block, x, w_out=torch.zeros_like(block.w_out))
    torch.testing.assert_close(out0, x, rtol=0, atol=1e-6)


def test_moe_capacity_formula():
    dims = _dims(moe, 8, 2, 4, capacity_factor=1.25)
    C = moe.capacity(64, dims)
    assert C >= 64 * 2 / 8 * 1.25
    assert C % 8 == 0


def test_moe_capacity_drop_changes_output():
    dims, block, x = _block_and_input(4, 2, 16, 32, 32, seed=0)
    out_full, _ = _run(block, x)
    block.dims = dims._replace(capacity_factor=0.05)
    out_tight, _ = _run(block, x)
    assert not torch.allclose(out_full, out_tight)
    assert float((out_tight - x).abs().mean()) <= float((out_full - x).abs().mean()) + 1e-6


def test_moe_aux_loss_balanced_vs_collapsed():
    _, block, x = _block_and_input(8, 1, 16, 16, 512, seed=3)
    _, aux_bal = _run(block, x, router=torch.zeros_like(block.router))
    collapsed = torch.zeros_like(block.router)
    collapsed[:, 0] = 20.0
    _, aux_col = _run(block, x, router=collapsed)
    assert float(aux_col) > float(aux_bal) * 1.5


def test_rowwise_matches_global_exactly_single_row():
    """One row (no mesh) is the global dispatch: the same bits."""
    dims, block, x = _block_and_input(8, 2, 16, 32, 64, seed=1)
    out_g, aux_g = _run(block, x)
    block.dims = dims._replace(dispatch="rowwise")
    out_r, aux_r = _run(block, x)
    assert torch.equal(out_g, out_r) and torch.equal(aux_g, aux_r)


def test_shared_expert_always_on():
    _, block, x = _block_and_input(4, 1, 16, 8, 16, seed=2, n_shared=1)
    out, _ = _run(block, x, w_out=torch.zeros_like(block.w_out))
    assert not torch.allclose(out, x)


def test_unknown_dispatch_raises():
    with pytest.raises(ValueError, match="dispatch"):
        moe.MoE(16, _dims(moe, 4, 1, 8, dispatch="nope"), torch.float32, "cpu")


# ---------------------------------------------------------------------------
# The MoE-family LMs (DeepSeek-V2-Lite: MLA + MoE; Kimi-K2: GQA + MoE)
# ---------------------------------------------------------------------------


def _carried(arch, seed=0, **replace):
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), **replace)
    cfg = dataclasses.replace(configs.get_reduced(arch), **replace)
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    state = lm_params_from_reference(jax.tree.map(np.asarray, jp), cfg)
    return jcfg, jp, cfg, Transformer.from_params(cfg, state, device="cpu")


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_lm_forward_matches_reference(monkeypatch, arch):
    """Logits, the summed aux loss, and every MoE layer's expert ids."""
    jcfg, jp, cfg, model = _carried(arch)
    toks = _tokens(cfg, (2, 16))
    (want, jaux), jids = _reference_ids(
        monkeypatch, lambda: JM.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg))
    with torch.no_grad():
        (got, aux), ids = _port_ids(monkeypatch, lambda: model(torch.from_numpy(toks)))
    assert len(ids) == len(jids) == cfg.n_periods
    for layer, (a, b) in enumerate(zip(ids, jids)):
        np.testing.assert_array_equal(a, b.reshape(a.shape), err_msg=f"MoE layer {layer}")
    assert float(aux) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_lm_prefill_and_decode_match_reference(arch):
    jcfg, jp, cfg, model = _carried(arch)
    toks = _tokens(cfg, (2, 17))
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
    key = f"00_{cfg.period[0]}"
    fields = ("c_kv", "k_pe") if cfg.period[0] == "mla" else ("k", "v")
    for f in fields:
        want = np.asarray(getattr(jcache2[key], f))
        for i in range(cfg.n_periods):
            np.testing.assert_allclose(getattr(cache[2 * i], f).numpy(), want[i],
                                       rtol=RTOL, atol=ATOL)
    assert all(c is None for c in cache[1::2])  # the MoE blocks keep no cache


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_lm_decode_from_empty_cache_matches_forward(arch):
    """Token-by-token decode from ``init_cache`` (each step's MoE routes B
    tokens, dropless in the reduced configs) gives forward's logits."""
    cfg = configs.get_reduced(arch)
    model = Transformer(cfg, device="cpu", seed=2)
    toks = torch.from_numpy(_tokens(cfg, (2, 9)))
    with torch.no_grad():
        full, _ = model(toks)
        cache = model.init_cache(2, S_max=9)
        steps = [model.decode_step(cache, toks[:, t], torch.full((2,), t))[0][:, 0]
                 for t in range(9)]
    torch.testing.assert_close(torch.stack(steps, dim=1), full, rtol=DECODE_TOL,
                               atol=DECODE_TOL)


def test_rowwise_moe_equals_global_single_device():
    """``tests/test_perf_variants.py::test_rowwise_moe_equals_global_single_device``
    on the port (the same bits: one row is the global dispatch), and both
    against the JAX package's loss."""
    jcfg, jp, cfg, model = _carried("kimi-k2-1t-a32b")
    row_cfg = dataclasses.replace(cfg, moe=cfg.moe._replace(dispatch="rowwise"))
    rowwise = Transformer.from_params(row_cfg, model.state_dict(), device="cpu")
    assert rowwise.blocks[1].dims.dispatch == "rowwise"
    toks = torch.from_numpy(_tokens(cfg, (2, 33), seed=0))
    with torch.no_grad():
        base = loss_fn(model, {"tokens": toks})
        row = loss_fn(rowwise, {"tokens": toks})
    assert torch.equal(base, row)
    want = float(JM.loss_fn(jp, {"tokens": jnp.asarray(toks.numpy(), jnp.int32)}, jcfg))
    assert abs(float(base) - want) <= ATOL + RTOL * abs(want)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_serve_generates_reference_tokens(arch):
    """``launch.serve.serve`` on the carried weights: the JAX package's
    greedy tokens."""
    jcfg = jconfigs.get_reduced(arch)
    want = jserve(jcfg, batch=2, prompt_len=8, gen_tokens=6, seed=0)
    params = lm_params_from_reference(
        jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), jcfg)),
        configs.get_reduced(arch))
    got = serve(configs.get_reduced(arch), batch=2, prompt_len=8, gen_tokens=6, seed=0,
                params=params, device="cpu")
    np.testing.assert_array_equal(got["generated"], want["generated"])
