"""Attention of the port: ``ops.multihead_attention`` and its flash kernel.

On the CPU the port's op runs its plain version, held against the JAX
package's ``ops.multihead_attention`` in Pallas interpret mode, on the cases
of ``tests/test_kernels.py`` and at that file's tolerances (2e-4 in fp32,
2e-2 in bf16).  The ``gpu``-marked tests hold the CUDA kernel against the
plain version on the card; each decides in the ``cuda`` fixture whether a
card is present and skips without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops, ref

# the JAX package's own tolerances for its flash kernel (tests/test_kernels.py)
F32_TOL = 2e-4
BF16_TOL = 2e-2


def _qkv(rng, B, Hq, Hkv, Sq, Sk, d, dv=None, dtype=np.float32):
    dv = d if dv is None else dv
    return (rng.standard_normal((B, Hq, Sq, d)).astype(dtype),
            rng.standard_normal((B, Hkv, Sk, d)).astype(dtype),
            rng.standard_normal((B, Hkv, Sk, dv)).astype(dtype))


def _port(q, k, v, causal, dtype=torch.float32, device="cpu", use_kernel=None):
    t = [torch.from_numpy(a).to(device=device, dtype=dtype) for a in (q, k, v)]
    return ops.multihead_attention(*t, causal=causal, use_kernel=use_kernel)


def _jax(q, k, v, causal, bq, bk, dtype=jnp.float32):
    j = [jnp.asarray(a, dtype) for a in (q, k, v)]
    return jops.multihead_attention(*j, causal=causal, bq=bq, bk=bk, interpret=True)


@pytest.mark.parametrize("B,Hq,Hkv,S,d,bq,bk", [
    (1, 2, 2, 128, 32, 64, 64),
    (2, 4, 2, 256, 32, 64, 64),     # GQA group 2
    (2, 8, 1, 128, 16, 64, 32),     # MQA
    (1, 2, 2, 192, 32, 64, 64),     # padded seq in the JAX op
])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_vs_reference(B, Hq, Hkv, S, d, bq, bk, causal):
    rng = np.random.default_rng(B * 100 + S)
    q, k, v = _qkv(rng, B, Hq, Hkv, S, S, d)
    got = _port(q, k, v, causal)
    want = np.asarray(_jax(q, k, v, causal, bq, bk))
    assert got.shape == (B, Hq, S, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_attention_mla_vdim():
    """v head dim != qk head dim (MLA layout)."""
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 1, 2, 2, 128, 128, 24, dv=16)
    got = _port(q, k, v, True)
    want = np.asarray(_jax(q, k, v, True, 64, 64))
    assert got.shape == (1, 2, 128, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_attention_bf16():
    rng = np.random.default_rng(9)
    q, k, v = _qkv(rng, 1, 2, 2, 128, 128, 32)
    got = _port(q, k, v, True, dtype=torch.bfloat16)
    want = _jax(q, k, v, True, 64, 64, dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_attention_causality():
    """Changing future tokens must not change past outputs."""
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, 1, 2, 2, 128, 128, 32)
    out1 = _port(q, k, v, True)
    k2, v2 = k.copy(), v.copy()
    k2[:, :, 100:] = 1000.0
    v2[:, :, 100:] = -7.0
    out2 = _port(q, k2, v2, True)
    np.testing.assert_allclose(out1[:, :, :100], out2[:, :, :100], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_jax_ref(causal):
    """The plain versions agree directly, ragged Sk included (non-causal)."""
    rng = np.random.default_rng(13)
    Sk = 96 if causal else 77
    q = rng.standard_normal((6, 96, 16)).astype(np.float32)
    k = rng.standard_normal((3, Sk, 16)).astype(np.float32)
    v = rng.standard_normal((3, Sk, 8)).astype(np.float32)
    got = ref.attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal,
                            q_heads_per_kv=2)
    want = jref.attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal,
                              q_heads_per_kv=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def test_causal_needs_equal_lengths():
    """Top-left (JAX kernel) and bottom-right (JAX plain version) causal masks
    differ when Sq != Sk; the port accepts causal only where they agree."""
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, 1, 2, 2, 16, 24, 8)
    with pytest.raises(ValueError, match="Sq == Sk"):
        _port(q, k, v, True)
    assert _port(q, k, v, False).shape == (1, 2, 16, 8)


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_mod.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="use_kernel=True"):
        ops.multihead_attention(x[None], x[None], x[None], use_kernel=True)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    # the plain version's products in full fp32
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


# (B, Hq, Hkv, Sq, Sk, d, dv, causal)
_CARD_CASES = [
    (1, 4, 1, 256, 256, 128, 128, True),     # GQA 4, the serve head size
    (2, 8, 2, 200, 200, 128, 128, True),     # ragged causal
    (1, 4, 2, 100, 333, 128, 128, False),    # ragged Sq and Sk
    (1, 2, 2, 130, 130, 64, 64, True),
    (1, 2, 1, 190, 190, 192, 128, True),     # dv != d (MLA)
    (2, 4, 2, 77, 77, 16, 16, True),         # the reduced configs' head size
    (1, 3, 3, 65, 150, 24, 16, False),       # scalar variant, ragged
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _CARD_CASES)
def test_flash_kernel_vs_plain(cuda, case, dtype):
    """The kernel against the plain version computed in fp32 from the same
    inputs: fp32 within the JAX tests' 2e-4, bf16 within their 2e-2."""
    B, Hq, Hkv, Sq, Sk, d, dv, causal = case
    rng = np.random.default_rng(Sq * 7 + d)
    q, k, v = _qkv(rng, B, Hq, Hkv, Sq, Sk, d, dv)
    before = ops.launch_counts()["flash_attention"]
    got = _port(q, k, v, causal, dtype=dtype, device=cuda)
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == (B, Hq, Sq, dv)
    t = [torch.from_numpy(a).to(cuda, dtype).float() for a in (q, k, v)]
    want = ops.multihead_attention(*t, causal=causal, use_kernel=False)
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


@pytest.mark.gpu
def test_flash_kernel_causality(cuda):
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, 1, 2, 2, 200, 200, 128)
    out1 = _port(q, k, v, True, dtype=torch.bfloat16, device=cuda)
    k[:, :, 150:] = 1000.0
    v[:, :, 150:] = -7.0
    out2 = _port(q, k, v, True, dtype=torch.bfloat16, device=cuda)
    assert torch.equal(out1[:, :, :150], out2[:, :, :150])


@pytest.mark.gpu
def test_flash_kernel_raises_on_bad_input(cuda):
    x = torch.zeros(2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_mod.flash_attention(x, x[:, :4], x[:, :4], causal=True)
    with pytest.raises(TypeError):
        flash_mod.flash_attention(x.half(), x.half(), x.half())
    with pytest.raises(ValueError):
        flash_mod.flash_attention(x, x[:1], x[:1], q_heads_per_kv=3)


# (B, Hq, Hkv, Sq, Sk, d, causal): shapes of the wgmma variant (128-row
# q-tiles, 128-key k-tiles) off its tile grid
_WGMMA_CASES = [
    (1, 4, 4, 300, 300, 128, True),      # group 1, Sq = Sk not a multiple of 128
    (1, 8, 2, 300, 300, 128, False),     # group 4, the same, not causal
    (1, 8, 1, 200, 200, 128, True),      # group 8
    (2, 4, 1, 50, 50, 128, True),        # Sk smaller than one k-tile
    (1, 4, 1, 1, 1, 128, True),          # S = 1
    (1, 4, 2, 1, 77, 128, False),        # one query row over a ragged Sk
    (1, 4, 2, 257, 90, 64, False),       # d = dv = 64
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", _WGMMA_CASES)
def test_flash_wgmma_vs_plain(cuda, case):
    """The wgmma + TMA variant against the plain version in fp32 on the same
    bf16 inputs, within the JAX tests' bf16 tolerance."""
    B, Hq, Hkv, Sq, Sk, d, causal = case
    assert flash_mod.variant(torch.bfloat16, d, d) == "wgmma"
    rng = np.random.default_rng(Sq * 11 + Sk + Hq)
    q, k, v = _qkv(rng, B, Hq, Hkv, Sq, Sk, d)
    got = _port(q, k, v, causal, dtype=torch.bfloat16, device=cuda)
    t = [torch.from_numpy(a).to(cuda, torch.bfloat16).float() for a in (q, k, v)]
    want = ops.multihead_attention(*t, causal=causal, use_kernel=False)
    torch.cuda.synchronize()
    assert got.shape == (B, Hq, Sq, d)
    torch.testing.assert_close(got.float(), want, rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wgmma_never_reads_past_a_head(cuda, causal):
    """q, k and v are views of buffers whose next head is NaN: a tile that
    crossed the last head's ragged edge would bring NaN into the output."""
    BHq, BHkv, S, d = 8, 2, 200, 128
    rng = np.random.default_rng(3)

    def with_nan_head(heads):
        buf = torch.full((heads + 1, S, d), float("nan"), dtype=torch.bfloat16, device=cuda)
        buf[:heads] = torch.from_numpy(rng.standard_normal((heads, S, d))).to(cuda)
        return buf[:heads]

    q, k, v = with_nan_head(BHq), with_nan_head(BHkv), with_nan_head(BHkv)
    assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
    got = flash_mod.flash_attention(q, k, v, causal=causal, q_heads_per_kv=BHq // BHkv)
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal,
                             q_heads_per_kv=BHq // BHkv)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want, rtol=BF16_TOL, atol=BF16_TOL)
