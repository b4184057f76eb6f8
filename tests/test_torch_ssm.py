"""The port's SSM mixers (Mamba, mLSTM, sLSTM) and SSM-family LMs against the
JAX package, on the CPU.

Weights come from the JAX package's initializers (carried with ``convert``
for whole models), inputs from a numpy seed; everything is fp32.

Tolerances:

* the scans against the reference and against a float64 step-by-step loop:
  rtol 1e-5 / atol 1e-6 for Mamba's (products and sums of values of order 1
  over at most 32 steps, in another order: the log-step scan pairs steps
  differently from XLA's tree), rtol 1e-4 / atol 1e-5 for mLSTM's (its
  exponentials and the normalizer's division add a few ulps each);
* mixers, logits and losses: the LM parity tolerance of
  ``tests/test_torch_lm.py``, rtol 1e-4 / atol 1e-5; gradients at rtol
  1e-4 / atol 5e-5: the largest leaves' entries (the embedding's, up to ~3.7)
  sum backward paths through the recurrences of every later block in
  another order, so their fp32 rounding reaches ~3.7 x 2^-23 x sqrt(~100
  terms) ~ 4e-6 to 2e-5 (1.9e-5 measured);
* the port's decode against its own forward: ``tests/test_models.py``'s
  2e-2 (xLSTM) and 2e-3 (Mamba) for token-by-token decode from an empty
  state, 5e-3 for prefill against forward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models import ssm as jssm
from repro.optim import AdamW as JAdamW
from repro_torch import configs
from repro_torch.convert import (_tensor, _unstack, adamw_state_from_reference,
                                 lm_params_from_reference)
from repro_torch.models import ssm
from repro_torch.models.model import ModelConfig, Transformer, loss_fn, make_train_step
from repro_torch.optim import AdamW

RTOL, ATOL = 1e-4, 1e-5
GRAD_ATOL = 5e-5
SCAN_TOL = (1e-5, 1e-6)
DECODE_TOL = 5e-3
SSM_ARCHS = ["xlstm-1.3b", "jamba-1.5-large-398b"]


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the scans and the cell
# ---------------------------------------------------------------------------


def _scan_loop(dA, dBx, C):
    """``h_t = dA_t h_{t-1} + dBx_t``; ``y_t = (h_t C_t).sum(-1)``, a step at a
    time in float64."""
    h = np.zeros(dA.shape[:1] + dA.shape[2:])
    ys = []
    for t in range(dA.shape[1]):
        h = dA[:, t] * h + dBx[:, t]
        ys.append((h * C[:, t, None, :]).sum(-1))
    return np.stack(ys, 1)


@pytest.mark.parametrize("T,chunk", [(32, 8), (32, 32), (24, 6), (12, 1)])
def test_ssm_scan_chunked_matches_reference_and_loop(T, chunk):
    rng = np.random.default_rng(T + chunk)
    dA = rng.uniform(0.5, 1.0, (2, T, 8, 4)).astype(np.float32)
    dBx = rng.standard_normal((2, T, 8, 4)).astype(np.float32)
    C = rng.standard_normal((2, T, 4)).astype(np.float32)
    got = ssm._ssm_scan_chunked(_t(dA), _t(dBx), _t(C), chunk).numpy()
    want = np.asarray(jssm._ssm_scan_chunked(jnp.asarray(dA), jnp.asarray(dBx),
                                             jnp.asarray(C), chunk))
    np.testing.assert_allclose(got, want, rtol=SCAN_TOL[0], atol=SCAN_TOL[1])
    np.testing.assert_allclose(got, _scan_loop(dA.astype(np.float64), dBx.astype(np.float64),
                                               C.astype(np.float64)),
                               rtol=SCAN_TOL[0], atol=SCAN_TOL[1])


def _mlstm_loop(q, k, v, li, lf):
    """The stabilized mLSTM recurrence (the decode step's) in float64, a step
    at a time from an empty state."""
    B, H, T, dh = q.shape
    C = np.zeros((B, H, dh, dh))
    n = np.zeros((B, H, dh))
    m = np.full((B, H), -1e30)
    out = []
    for t in range(T):
        m_new = np.maximum(lf[..., t] + m, li[..., t])
        i_p = np.exp(li[..., t] - m_new)[..., None]
        f_p = np.exp(lf[..., t] + m - m_new)[..., None]
        C = f_p[..., None] * C + i_p[..., None] * k[..., t, :, None] * v[..., t, None, :]
        n = f_p * n + i_p * k[..., t, :]
        qs = q[..., t, :] / dh ** 0.5
        num = np.einsum("bhd,bhde->bhe", qs, C)
        den = np.einsum("bhd,bhd->bh", qs, n)
        out.append(num / np.maximum(np.abs(den), np.exp(-m_new))[..., None])
        m = m_new
    return np.stack(out, 2)


@pytest.mark.parametrize("chunk", [8, 32, 1])
def test_mlstm_chunk_scan_matches_reference_and_loop(chunk):
    rng = np.random.default_rng(chunk)
    B, H, T, dh = 2, 2, 32, 8
    q, k, v = (rng.standard_normal((B, H, T, dh)).astype(np.float32) for _ in range(3))
    li = rng.standard_normal((B, H, T)).astype(np.float32)
    lf = np.log(1 / (1 + np.exp(-(rng.standard_normal((B, H, T)) + 3.0)))).astype(np.float32)
    got = ssm._mlstm_chunk_scan(_t(q), _t(k), _t(v), _t(li), _t(lf), chunk).numpy()
    want = np.asarray(jssm._mlstm_chunk_scan(*(jnp.asarray(a) for a in (q, k, v, li, lf)),
                                             chunk))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    loop = _mlstm_loop(*(a.astype(np.float64) for a in (q, k, v, li, lf)))
    np.testing.assert_allclose(got, loop, rtol=RTOL, atol=ATOL)


def test_slstm_cell_matches_reference():
    rng = np.random.default_rng(0)
    B, d, H = 3, 16, 4
    dh = d // H
    r = (rng.standard_normal((H, dh, 4 * dh)) / dh ** 0.5).astype(np.float32)
    xw = rng.standard_normal((B, 4 * d)).astype(np.float32)
    c, n, h = (rng.standard_normal((B, d)).astype(np.float32) for _ in range(3))
    n = np.abs(n)
    m = rng.standard_normal((B, d)).astype(np.float32)
    got = ssm._slstm_cell(_t(r), _t(xw), ssm.SLSTMState(_t(c), _t(n), _t(h), _t(m)))
    want = jssm._slstm_cell({"r": jnp.asarray(r)}, jnp.asarray(xw),
                            jssm.SLSTMState(*(jnp.asarray(a) for a in (c, n, h, m))), H)
    for name, g, w in zip(ssm.SLSTMState._fields, got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------

D_MODEL = 32
MIXERS = {
    "mamba": (lambda: jssm.MambaDims(d_inner=64, d_state=8),
              lambda: ssm.MambaDims(d_inner=64, d_state=8)),
    "mlstm": (lambda: jssm.MLSTMDims(d_inner=64, n_heads=4),
              lambda: ssm.MLSTMDims(d_inner=64, n_heads=4)),
    "slstm": (lambda: jssm.SLSTMDims(n_heads=4), lambda: ssm.SLSTMDims(n_heads=4)),
}
_J_INIT = {"mamba": jssm.init_params, "mlstm": jssm.mlstm_init_params,
           "slstm": jssm.slstm_init_params}


def _port_mixer(kind, dims, chunk, gen=None, dtype=torch.float32):
    if kind == "mamba":
        return ssm.Mamba(D_MODEL, dims, chunk, dtype, "cpu", gen)
    if kind == "mlstm":
        return ssm.MLSTM(D_MODEL, dims, chunk, dtype, "cpu", gen)
    return ssm.SLSTM(D_MODEL, dims, dtype, "cpu", gen)


def _carried_mixer(kind, chunk=8, seed=0):
    """(JAX params, JAX dims, the port's mixer holding those params)."""
    jdims, pdims = (f() for f in MIXERS[kind])
    jp = _J_INIT[kind](jax.random.PRNGKey(seed), D_MODEL, jdims, jnp.float32)
    block = _port_mixer(kind, pdims, chunk)
    block.load_state_dict({k: _t(v) for k, v in jp.items()})
    return jp, jdims, block


def _j_forward(kind, jp, x, jdims, chunk):
    if kind == "mamba":
        return jssm.forward(jp, x, jdims, chunk)
    if kind == "mlstm":
        return jssm.mlstm_forward(jp, x, jdims, chunk)
    return jssm.slstm_forward(jp, x, jdims)


@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_init_matches_reference(kind):
    """The reference's leaf names in its order, shapes and types; the
    deterministic leaves equal exactly; the random ones drawn with the
    reference's scales."""
    jdims, pdims = (f() for f in MIXERS[kind])
    jp = _J_INIT[kind](jax.random.PRNGKey(0), D_MODEL, jdims, jnp.bfloat16)
    block = _port_mixer(kind, pdims, 8, torch.Generator().manual_seed(0), torch.bfloat16)
    got = dict(block.named_parameters())
    assert list(got) == list(jp)
    deterministic = {"norm_scale", "conv_b", "A_log", "D", "b_i", "b_f", "out_norm", "b"}
    for name, w in jp.items():
        g = got[name].detach()
        w = np.asarray(w.astype(jnp.float32))
        assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16, name
        g = g.float().numpy()
        if name in deterministic:
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif name == "dt_bias":  # softplus^-1 of exp(U(log 1e-3, log 1e-1))
            assert g.min() > np.log(np.expm1(1e-3)) - 1e-2 and g.max() < np.log(np.expm1(0.1))
        else:
            assert abs(g.std() / w.std() - 1) < 0.25, name


@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_forward_matches_reference(kind):
    jp, jdims, block = _carried_mixer(kind)
    x = np.random.default_rng(1).standard_normal((2, 16, D_MODEL)).astype(np.float32)
    want = _j_forward(kind, jp, jnp.asarray(x), jdims, 8)
    with torch.no_grad():
        got, aux = block(_t(x))
    assert aux is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


_J_STATE = {"mamba": lambda B, d: jssm.init_state(B, d, jnp.float32),
            "mlstm": lambda B, d: jssm.mlstm_init_state(B, d, jnp.float32),
            "slstm": lambda B, d: jssm.slstm_init_state(B, D_MODEL, jnp.float32)}
_J_DECODE = {"mamba": jssm.decode_step, "mlstm": jssm.mlstm_decode_step,
             "slstm": jssm.slstm_decode_step}


@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_decode_step_matches_reference(kind):
    """Four steps from an empty state: the outputs and every state field,
    the state updated in place."""
    jp, jdims, block = _carried_mixer(kind)
    x = np.random.default_rng(2).standard_normal((2, 4, D_MODEL)).astype(np.float32)
    jstate = _J_STATE[kind](2, jdims)
    state = block.init_cache(2, 4, torch.float32, "cpu")
    assert [tuple(s.shape) for s in state] == [s.shape for s in jstate]
    assert [s.dtype for s in state] == [torch.float32] * len(state)
    fields = [s.data_ptr() for s in state]
    for t in range(4):
        want, jstate = _J_DECODE[kind](jp, jnp.asarray(x[:, t:t + 1]), jstate, jdims)
        with torch.no_grad():
            got, state = block.decode_step(_t(x[:, t:t + 1]), state, torch.full((2,), t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        for name, s, w in zip(state._fields, state, jstate):
            np.testing.assert_allclose(s.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                       err_msg=name)
    assert [s.data_ptr() for s in state] == fields


@pytest.mark.parametrize("kind", ["mamba", "mlstm"])
def test_length_not_a_multiple_of_the_chunk_raises(kind):
    """The reference's ``T % chunk == 0`` (an assert there): nothing is
    padded."""
    _, _, block = _carried_mixer(kind, chunk=8)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        block(torch.zeros((1, 12, D_MODEL)))
    block(torch.zeros((1, 6, D_MODEL)))  # chunk = min(8, T)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        if kind == "mamba":
            ssm._ssm_scan_chunked(torch.ones(1, 6, 2, 2), torch.ones(1, 6, 2, 2),
                                  torch.ones(1, 6, 2), 4)
        else:
            ssm._mlstm_chunk_scan(*[torch.ones(1, 1, 6, 2)] * 3, torch.zeros(1, 1, 6),
                                  torch.zeros(1, 1, 6), 4)


# ---------------------------------------------------------------------------
# the port's own decode contracts (tests/test_models.py)
# ---------------------------------------------------------------------------


def test_ssm_decode_matches_forward_stepwise():
    """``tests/test_models.py::test_ssm_decode_matches_forward_stepwise`` on
    the port: token-by-token decode of the reduced xLSTM from ``init_cache``
    gives forward's logits (2e-2)."""
    cfg = configs.get_reduced("xlstm-1.3b")
    model = Transformer(cfg, device="cpu", seed=2)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 12)))
    with torch.no_grad():
        full, _ = model(toks)
        cache = model.init_cache(1, S_max=12)
        steps = [model.decode_step(cache, toks[:, t], torch.tensor([t]))[0][:, 0]
                 for t in range(12)]
    torch.testing.assert_close(torch.stack(steps, 1), full, rtol=2e-2, atol=2e-2)


def test_mamba_decode_matches_forward_stepwise():
    """``tests/test_models.py::test_mamba_decode_matches_forward_stepwise``
    on the port (2e-3)."""
    cfg = ModelConfig(name="mamba-test", family="ssm", n_periods=2, period=("mamba",),
                      d_model=32, vocab_size=64, dtype="float32", ssm_chunk=4,
                      mamba=ssm.MambaDims(d_inner=64, d_state=8), sub_quadratic=True)
    model = Transformer(cfg, device="cpu", seed=3)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 64, (1, 8)))
    with torch.no_grad():
        full, _ = model(toks)
        cache = model.init_cache(1, S_max=8)
        steps = [model.decode_step(cache, toks[:, t], torch.tensor([t]))[0][:, 0]
                 for t in range(8)]
    torch.testing.assert_close(torch.stack(steps, 1), full, rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# the reduced xLSTM and Jamba against the reference
# ---------------------------------------------------------------------------


def _carried(arch, seed=0):
    jcfg, cfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    state = lm_params_from_reference(jax.tree.map(np.asarray, jp), cfg)
    return jcfg, jp, cfg, Transformer.from_params(cfg, state, device="cpu")


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_forward_matches_reference(arch):
    jcfg, jp, cfg, model = _carried(arch)
    toks = _tokens(cfg, (2, 32))
    want, jaux = JM.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg)
    with torch.no_grad():
        got, aux = model(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """The prefill's last logits, its caches (an SSM block's a fresh state,
    as the reference's: the documented serving limitation, not the state at
    the prompt's end), then one decode step, against the reference; the
    prefill's logits against the port's own forward (5e-3)."""
    jcfg, jp, cfg, model = _carried(arch)
    toks = _tokens(cfg, (2, 17))
    jl, jcache = JM.prefill(jp, {"tokens": jnp.asarray(toks[:, :16], jnp.int32)}, jcfg,
                            S_max=18)
    pos = np.full((2,), 16)
    jd, jcache2 = JM.decode_step(jp, jcache, jnp.asarray(toks[:, 16], jnp.int32),
                                 jnp.asarray(pos, jnp.int32), jcfg)
    with torch.no_grad():
        tl, cache = model.prefill(torch.from_numpy(toks[:, :16]), S_max=18)
        full, _ = model(torch.from_numpy(toks[:, :16]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(tl[:, 0], full[:, -1], rtol=DECODE_TOL, atol=DECODE_TOL)
        P = len(cfg.period)
        for i, (blk, c) in enumerate(zip(model.blocks, cache)):
            btype = cfg.period[i % P]
            if btype in ("mamba", "mlstm", "slstm"):
                fresh = blk.init_cache(2, 18, torch.float32, "cpu")
                ref_state = jcache[f"{i % P:02d}_{btype}"]
                for name, s, f, w in zip(c._fields, c, fresh, ref_state):
                    assert torch.equal(s, f), (i, name)
                    np.testing.assert_array_equal(s.numpy(), np.asarray(w)[i // P])
        td, cache = model.decode_step(cache, torch.from_numpy(toks[:, 16]),
                                      torch.from_numpy(pos))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)
    for i, c in enumerate(cache):  # the states after the step, in place
        btype = cfg.period[i % P]
        if btype in ("mamba", "mlstm", "slstm"):
            for name, s, w in zip(c._fields, c, jcache2[f"{i % P:02d}_{btype}"]):
                np.testing.assert_allclose(s.numpy(), np.asarray(w)[i // P], rtol=RTOL,
                                           atol=ATOL, err_msg=f"{i} {name}")


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_loss_and_grads_match_reference(arch):
    """The loss (CE, + MoE aux for Jamba) and every gradient, remat full."""
    jcfg, jp, cfg, model = _carried(arch)
    toks = _tokens(cfg, (2, 33))
    jl, jg = jax.value_and_grad(JM.loss_fn)(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg)
    params = dict(model.named_parameters())
    loss = loss_fn(model, {"tokens": torch.from_numpy(toks)})
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    assert abs(float(loss.detach()) - float(jl)) <= ATOL + RTOL * abs(float(jl))
    want = _unstack(jax.tree.map(np.asarray, jg), cfg)
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], rtol=RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_train_steps_match_reference(arch):
    """Two ``make_train_step`` steps on one batch from the same parameters and
    the reference's ``AdamWState`` (carried with ``convert``): the same
    losses, finite and falling."""
    jcfg, jp, cfg, model = _carried(arch)
    toks = _tokens(cfg, (2, 33))
    kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    jopt, opt = JAdamW(**kw), AdamW(**kw)
    jst = jopt.init(jp)
    st = adamw_state_from_reference(jax.tree.map(np.asarray, jst), cfg)
    jstep = jax.jit(JM.make_train_step(jcfg, jopt))
    step = make_train_step(opt)
    jb, b = {"tokens": jnp.asarray(toks, jnp.int32)}, {"tokens": torch.from_numpy(toks)}
    jl, ls = [], []
    for _ in range(2):
        loss, jp, jst = jstep(jp, jst, jb)
        jl.append(float(loss))
        loss, st = step(model, st, b)
        ls.append(float(loss))
    np.testing.assert_allclose(ls, jl, rtol=RTOL, atol=ATOL)
    assert np.isfinite(ls).all() and ls[1] < ls[0]


@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_bf16_rounds_as_reference(kind):
    """In bf16 (the card's type) the port rounds where the reference does:
    its output is no further from the fp32 mixer than twice the reference's
    bf16 output is (the ``LM_FACTOR`` rule of ``chip_smoke.py``; a cast
    dropped or added moves it by the output's whole bf16 rounding, 2^-7
    relative, instead)."""
    jdims, pdims = (f() for f in MIXERS[kind])
    jp = _J_INIT[kind](jax.random.PRNGKey(0), D_MODEL, jdims, jnp.bfloat16)
    block = _port_mixer(kind, pdims, 8, dtype=torch.bfloat16)
    block.load_state_dict({k: _tensor(np.asarray(v)) for k, v in jp.items()})
    x = jnp.asarray(np.random.default_rng(1).standard_normal((2, 16, D_MODEL)), jnp.bfloat16)
    jbf16 = np.asarray(_j_forward(kind, jp, x, jdims, 8).astype(jnp.float32))
    fp32 = np.asarray(_j_forward(kind, jax.tree.map(lambda a: a.astype(jnp.float32), jp),
                                 x.astype(jnp.float32), jdims, 8))
    with torch.no_grad():
        got = block(_tensor(np.asarray(x)))[0]
    assert got.dtype == torch.bfloat16
    err, ref_err = np.abs(got.float().numpy() - fp32).max(), np.abs(jbf16 - fp32).max()
    assert 0 < err <= 2 * ref_err, (err, ref_err)
