"""The port's MLA block (DeepSeek-V2's latent attention) against the JAX
package, on the CPU.

Weights come from ``repro.models.mla.init_params`` and inputs from a numpy
seed, fp32, held at the LM parity tolerance of ``tests/test_torch_lm.py``,
rtol 1e-4 / atol 1e-5 (the same products summed in another order): the
forward, prefill (output and latent cache), and decode steps with their
in-place cache writes (the reference adds through a one-hot). Head sizes
cover the reduced config's and one with v_head_dim != qk_nope_dim +
qk_rope_dim. The whole-model cases are in ``tests/test_torch_moe.py``; the
card's kernel path in ``tests/test_torch_gpu_moe.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mla as jmla
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.models import layers, mla
from repro_torch.models.model import Transformer

RTOL, ATOL = 1e-4, 1e-5
DIMS = {  # (n_heads, kv_lora_rank, qk_nope_dim, qk_rope_dim, v_head_dim)
    "reduced": (4, 16, 16, 8, 16),
    "dv-differs": (2, 8, 8, 4, 12),
}


def _carried(which, d_model=32, seed=0, S=12, B=2):
    """(JAX dims, JAX params, the port's block holding them, x, positions)."""
    H, r, nope, rope, v = DIMS[which]
    kw = dict(n_heads=H, kv_lora_rank=r, qk_nope_dim=nope, qk_rope_dim=rope,
              v_head_dim=v, rope_theta=1e4)
    jdims = jmla.MLADims(**kw)
    jp = jmla.init_params(jax.random.PRNGKey(seed), d_model, jdims, jnp.float32)
    block = mla.MLA(d_model, mla.MLADims(**kw), torch.float32, "cpu")
    block.load_state_dict({n: torch.from_numpy(np.array(a)) for n, a in jp.items()})
    x = np.random.default_rng(seed).standard_normal((B, S, d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    return jdims, jp, block, x, pos


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_dims_copied_exactly():
    assert mla.MLADims._fields == jmla.MLADims._fields
    assert mla.MLADims._field_defaults == jmla.MLADims._field_defaults
    assert mla.MLACache._fields == jmla.MLACache._fields


@pytest.mark.parametrize("which", list(DIMS))
def test_mla_forward_matches_reference(which):
    jdims, jp, block, x, pos = _carried(which)
    want = jmla.forward(jp, jnp.asarray(x), jdims, jnp.asarray(pos))
    with torch.no_grad():
        got, aux = block(torch.from_numpy(x), torch.from_numpy(pos.copy()))
    assert aux is None
    _close(got, want)


@pytest.mark.parametrize("which", list(DIMS))
def test_mla_prefill_and_decode_match_reference(which):
    """Prefill over 12 tokens into an S_max = 15 cache, then three decode
    steps: outputs and both cache leaves equal the reference's each step."""
    jdims, jp, block, x, pos = _carried(which)
    rng = np.random.default_rng(7)
    S, S_max = x.shape[1], 15
    jy, jc = jmla.prefill(jp, jnp.asarray(x), jdims, jnp.asarray(pos), S_max)
    with torch.no_grad():
        y, cache = block.prefill(torch.from_numpy(x), torch.from_numpy(pos.copy()), S_max)
    _close(y, jy)
    for t in range(3):
        xt = rng.standard_normal((x.shape[0], 1, x.shape[2])).astype(np.float32)
        p = np.full((x.shape[0],), S + t)
        jy, jc = jmla.decode_step(jp, jnp.asarray(xt), jc, jdims, jnp.asarray(p))
        with torch.no_grad():
            y, cache = block.decode_step(torch.from_numpy(xt), cache, torch.from_numpy(p))
        _close(y, jy)
        _close(cache.c_kv, jc.c_kv)
        _close(cache.k_pe, jc.k_pe)


def test_mla_decode_from_empty_cache_matches_forward():
    """Decode token by token from ``init_cache`` gives the forward's outputs
    (causal: each step sees the same prefix)."""
    _, _, block, x, pos = _carried("dv-differs", S=6)
    B, S, _ = x.shape
    with torch.no_grad():
        full, _ = block(torch.from_numpy(x), torch.from_numpy(pos.copy()))
        cache = block.init_cache(B, S, torch.float32, "cpu")
        steps = [block.decode_step(torch.from_numpy(x[:, t:t + 1]), cache,
                                   torch.full((B,), t))[0] for t in range(S)]
    torch.testing.assert_close(torch.cat(steps, dim=1), full, rtol=RTOL, atol=ATOL)


def test_mla_attends_head_major_aligned(monkeypatch):
    """q and k reach the attention op contiguous in the
    kernel's (B, H, S, nope + rope) layout (so its flattening is a view and
    its 16-byte alignment check copies nothing), k's rope part equal to
    ``k_pe`` on every head; v is (B, H, S, dv)."""
    _, _, block, x, pos = _carried("reduced")
    H, _, nope, rope, v = DIMS["reduced"]
    seen = {}
    attend = ops.multihead_attention

    def recording(q, k, v_, **kw):
        seen.update(q=q, k=k, v=v_)
        return attend(q, k, v_, **kw)

    monkeypatch.setattr(ops, "multihead_attention", recording)
    with torch.no_grad():
        x_t = torch.from_numpy(x)
        block(x_t, torch.from_numpy(pos.copy()))
        _, k_pe = block._latent(layers.rms_norm(x_t, block.norm_scale),
                                torch.from_numpy(pos.copy()))
    B, S = x.shape[:2]
    q, k = seen["q"], seen["k"]
    assert q.shape == k.shape == (B, H, S, nope + rope) and seen["v"].shape == (B, H, S, v)
    assert q.is_contiguous() and k.is_contiguous()
    assert q.data_ptr() % 16 == 0 and k.data_ptr() % 16 == 0
    for hd in range(H):
        assert torch.equal(k[:, hd, :, nope:], k_pe)


def test_chunked_impl_raises():
    """Only an unknown attention implementation raises now; the chunked one
    (once raising, item 14h) builds, and its block forward matches the
    reference's chunked MLA (``jmla.forward`` through
    ``attention._chunked_attention``) at the parity tolerance, both at
    chunks of 4 over S = 12 and ragged (chunk 5)."""
    cfg = configs.get_reduced("deepseek-v2-lite-16b")
    with pytest.raises(ValueError, match="unknown attn_impl"):
        Transformer(dataclasses.replace(cfg, attn_impl="flash"), device="cpu")
    with pytest.raises(ValueError, match="unknown attn_impl"):
        mla.MLA(16, cfg.mla._replace(impl="flash"), torch.float32, "cpu")
    Transformer(dataclasses.replace(cfg, attn_impl="chunked"), device="cpu")
    jdims, jp, block, x, pos = _carried("dv-differs")
    for chunk in (4, 5):
        block.dims = block.dims._replace(impl="chunked", chunk=chunk)
        want = jmla.forward(jp, jnp.asarray(x), jdims._replace(impl="chunked", chunk=chunk),
                            jnp.asarray(pos))
        with torch.no_grad():
            got, _ = block(torch.from_numpy(x), torch.from_numpy(pos.copy()))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
