"""The port's kernel ops on the CPU, held against the JAX package.

The port's plain PyTorch versions (what its ops run on CPU tensors) are held
against ``repro.kernels.ref`` on the shape grids of ``tests/test_kernels.py``,
and against the Pallas kernels run in interpret mode on a few shapes.  The
canonical Gram order is held bit for bit inside the port: a chunked reduction
equals one call.  The CUDA kernels themselves are tested on the card
(``tests/test_torch_gpu.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ihb as j_ihb
from repro.core import oavi as j_oavi
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from test_torch_gpu import PSI, degree_inputs

# Grams: the same fp32 products summed in another order (library matmul
# blocking), sums of non-negative terms — the tolerance tests/test_kernels.py
# holds the Pallas kernel to.
GRAM_RTOL, GRAM_ATOL = 1e-5, 1e-5
# IHB update: a matvec in another order, divided by the Schur complement —
# the tolerance tests/test_kernels.py::test_ihb_update_vs_ref uses.
IHB_RTOL, IHB_ATOL = 1e-4, 1e-5

GRAM_GRID = [  # tests/test_kernels.py::test_gram_update_shapes
    (256, 8, 4, 8, 128),
    (512, 32, 8, 16, 256),
    (1000, 16, 3, 32, 512),  # padded m
    (128, 64, 16, 8, 128),
]
IHB_GRID = [(8, 3), (16, 7), (32, 20), (64, 1)]  # test_ihb_update_vs_ref
# The degree loop: both packages chain fp32 Theorem 4.9 updates with matvecs
# summed in another order; the inverse engine's fit-parity tolerance
# (tests/test_torch_oavi.py, where the reason is spelled out)
DEGREE_TOL = dict(rtol=5e-3, atol=2e-3)
BAND = 1e-3  # verdicts within BAND * psi of psi may flip between sum orders


def _gram_inputs(seed, m, L, n, K):
    rng = np.random.default_rng(seed)
    A = rng.uniform(0, 1, (m, L)).astype(np.float32)
    X = rng.uniform(0, 1, (m, n)).astype(np.float32)
    p = rng.integers(0, L, K)
    v = rng.integers(0, n, K)
    return A, X, p, v


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("m,L,n,K,bm", GRAM_GRID)
def test_gram_update_plain_vs_ref(m, L, n, K, bm):
    A, X, p, v = _gram_inputs(m + L + K, m, L, n, K)
    Psel, Vsel = jops.selection_matrices(
        jnp.asarray(p, jnp.int32), jnp.asarray(v, jnp.int32), L, n, jnp.float32
    )
    want = jref.gram_update_ref(jnp.asarray(A), jnp.asarray(X), Psel, Vsel)
    got = ops.gram_update(*_t(A, X, p, v), bm=bm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAM_RTOL, atol=GRAM_ATOL)


@pytest.mark.parametrize("m,L,n,K,bm", GRAM_GRID)
def test_gram_accumulate_plain_vs_ref(m, L, n, K, bm):
    A, X, p, v = _gram_inputs(m * 7 + K, m, L, n, K)
    rng = np.random.default_rng(K)
    ql0 = rng.uniform(0, 1, (L, K)).astype(np.float32)
    c0 = rng.uniform(0, 1, (K, K)).astype(np.float32)
    want = jops.gram_accumulate(
        jnp.asarray(A), jnp.asarray(X), jnp.asarray(p, jnp.int32),
        jnp.asarray(v, jnp.int32), (jnp.asarray(ql0), jnp.asarray(c0)), bm=bm,
    )
    At, Xt, pt, vt, q0, cc0 = _t(A, X, p, v, ql0, c0)
    got = ops.gram_accumulate(At, Xt, pt, vt, (q0, cc0), bm=bm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAM_RTOL, atol=GRAM_ATOL)


@pytest.mark.parametrize("m,L,n,K", [(512, 12, 5, 9), (1000, 16, 3, 32)])
def test_gram_accumulate_plain_vs_pallas_interpret(m, L, n, K):
    A, X, p, v = _gram_inputs(m - K, m, L, n, K)
    want = jops.gram_accumulate(
        jnp.asarray(A), jnp.asarray(X), jnp.asarray(p, jnp.int32),
        jnp.asarray(v, jnp.int32), interpret=True,
    )
    got = ops.gram_accumulate(*_t(A, X, p, v))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAM_RTOL, atol=GRAM_ATOL)


@pytest.mark.parametrize("splits", [(256,), (512, 1280), (256, 768, 1024, 2048)])
def test_gram_accumulate_chunk_invariance_bit_exact(splits):
    """Chained calls over row chunks (multiples of GRAM_BLOCK, the last one
    ragged) land on the bits of one call."""
    A, X, p, v = _gram_inputs(len(splits), 2300, 24, 4, 20)
    At, Xt, pt, vt = _t(A, X, p, v)
    whole = ops.gram_accumulate(At, Xt, pt, vt)
    acc = None
    edges = (0,) + splits + (2300,)
    for lo, hi in zip(edges[:-1], edges[1:]):
        acc = ops.gram_accumulate(At[lo:hi], Xt[lo:hi], pt, vt, acc)
    for a, b in zip(whole, acc):
        assert torch.equal(a, b)


def test_gram_accumulate_zero_rows_are_noops():
    A, X, p, v = _gram_inputs(11, 700, 10, 3, 12)
    At, Xt, pt, vt = _t(A, X, p, v)
    pad = lambda T: torch.cat([T, T.new_zeros((300, T.shape[1]))])  # noqa: E731
    a = ops.gram_accumulate(At, Xt, pt, vt)
    b = ops.gram_accumulate(pad(At), pad(Xt), pt, vt)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _ihb_inputs(L, ell):
    rng = np.random.default_rng(L * 31 + ell)
    m = 200
    Araw = rng.uniform(0, 1, (m, ell)).astype(np.float32)
    G = Araw.T @ Araw / m + 1e-3 * np.eye(ell, dtype=np.float32)
    N = np.eye(L, dtype=np.float32)
    N[:ell, :ell] = np.linalg.inv(G)
    b = rng.uniform(0, 1, m).astype(np.float32)
    q = np.zeros(L, np.float32)
    q[:ell] = Araw.T @ b / m
    btb = np.float32(b @ b / m)
    return N, q, btb


@pytest.mark.parametrize("L,ell", IHB_GRID)
def test_ihb_update_plain_vs_ref(L, ell):
    N, q, btb = _ihb_inputs(L, ell)
    want = jref.ihb_update_ref(jnp.asarray(N), jnp.asarray(q), btb, ell)
    got = ops.ihb_update(torch.from_numpy(N), torch.from_numpy(q), float(btb), ell)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=IHB_RTOL, atol=IHB_ATOL)


@pytest.mark.parametrize("L,ell", [(16, 7), (64, 1)])
def test_ihb_update_plain_vs_pallas_interpret(L, ell):
    N, q, btb = _ihb_inputs(L, ell)
    want = jops.ihb_update(jnp.asarray(N), jnp.asarray(q), btb, ell, interpret=True)
    got = ops.ihb_update(torch.from_numpy(N), torch.from_numpy(q), float(btb), ell)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=IHB_RTOL, atol=IHB_ATOL)


@pytest.mark.parametrize("L,ell", IHB_GRID)
def test_ihb_update_identity_padding_exact(L, ell):
    N, q, btb = _ihb_inputs(L, ell)
    Nt = torch.from_numpy(N)
    ell_t = torch.tensor(ell)
    got = ops.ihb_update(Nt, torch.from_numpy(q), torch.tensor(btb), ell_t)
    assert torch.equal(got[ell + 1:, ell + 1:], Nt[ell + 1:, ell + 1:])
    assert torch.equal(got[ell, ell + 1:], torch.zeros(L - ell - 1))
    assert torch.equal(got[ell + 1:, ell], torch.zeros(L - ell - 1))
    # a gated-off update returns N unchanged, bit for bit
    off = ops.ihb_update(Nt, torch.from_numpy(q), torch.tensor(btb), ell_t,
                         active=torch.tensor(False))
    assert torch.equal(off, Nt)


@pytest.mark.parametrize("L,ell", IHB_GRID)
def test_ihb_update_in_place_equals_functional(L, ell):
    """The fit's in-place update gives the functional update's bits, and
    neither touches the block past ell + 1."""
    N, q, btb = _ihb_inputs(L, ell)
    Nt = torch.from_numpy(N)
    args = (torch.from_numpy(q), torch.tensor(btb), torch.tensor(ell, dtype=torch.int32))
    functional = ops.ihb_update(Nt, *args)
    assert torch.equal(Nt, torch.from_numpy(N))  # N itself unchanged
    inplace = Nt.clone()
    assert ops.ihb_update_(inplace, *args) is inplace
    assert torch.equal(inplace, functional)
    for got in (functional, inplace):
        assert torch.equal(got[ell + 1:, :], Nt[ell + 1:, :])
        assert torch.equal(got[:, ell + 1:], Nt[:, ell + 1:])


def _j_degree(QLt, C, N, ell0, K):
    """The JAX package's statistics-only degree step, fast engine, on the raw
    Grams with m_total = 1 (so its 1/m is exactly 1)."""
    step = j_oavi._make_stats_degree_step(j_oavi.OAVIConfig(engine="fast", psi=PSI))
    state = j_ihb.IHBState(AtA=None, N=jnp.asarray(N), R=None)
    st = step(jnp.asarray(QLt.T), jnp.asarray(C), state, jnp.asarray(ell0, jnp.int32),
              jnp.ones((C.shape[0],), bool), 1)
    return st


@pytest.mark.parametrize("Lcap,ell0,K,pattern", [
    (16, 3, 10, "mixed"),
    (32, 5, 20, "mixed"),
    (64, 4, 40, "mixed"),
    (32, 4, 16, "all"),
    (32, 4, 16, "none"),
])
def test_ihb_degree_plain_vs_reference(Lcap, ell0, K, pattern):
    rng = np.random.default_rng(Lcap + K)
    appended = {"all": np.ones(K, bool), "none": np.zeros(K, bool),
                "mixed": rng.uniform(size=K) < 0.5}[pattern]
    QLt, C, N = degree_inputs(Lcap * K + ell0, Lcap, ell0, K, appended)
    st = _j_degree(QLt, C, N, ell0, K)
    # a copy: the JAX step may still be reading N (its CPU arrays can alias
    # numpy memory and it runs asynchronously) while the port updates Nt
    Nt = torch.from_numpy(N.copy())
    acc, mses, coeffs, slots, ell = ops.ihb_degree(torch.from_numpy(QLt),
                                                   torch.from_numpy(C), Nt, ell0, PSI, K)
    j_mses = np.asarray(st.mses)
    assert not np.any(np.abs(j_mses - PSI) <= BAND * PSI)  # no verdict in the band
    assert np.array_equal(acc.numpy(), ~appended)
    assert np.array_equal(acc.numpy(), np.asarray(st.accepted))
    assert np.array_equal(slots.numpy(), np.asarray(st.slots))
    assert int(ell) == int(st.ell) == ell0 + appended.sum()
    np.testing.assert_allclose(mses.numpy(), j_mses, **DEGREE_TOL)
    np.testing.assert_allclose(coeffs.numpy(), np.asarray(st.coeffs), **DEGREE_TOL)
    np.testing.assert_allclose(Nt.numpy(), np.asarray(st.ihb.N), **DEGREE_TOL)
    # N was updated in place; past the final active block it is untouched
    e = int(ell)
    assert torch.equal(Nt[e:, :], torch.from_numpy(N)[e:, :])
    assert torch.equal(Nt[:, e:], torch.from_numpy(N)[:, e:])


def test_ops_use_kernel_on_cpu_raises():
    A = torch.zeros(256, 4)
    p = torch.zeros(3, dtype=torch.long)
    with pytest.raises(ValueError):
        ops.gram_accumulate(A, A, p, p, use_kernel=True)
    with pytest.raises(ValueError):
        ops.ihb_update(torch.eye(4), torch.zeros(4), 1.0, 1, use_kernel=True)
    with pytest.raises(ValueError):
        ops.ihb_degree(torch.zeros(4, 8), torch.eye(4), torch.eye(8), 1, PSI, 4,
                       use_kernel=True)


def test_cpu_ops_launch_no_kernel():
    before = ops.launch_counts()
    A, X, p, v = _gram_inputs(0, 300, 8, 3, 5)
    ops.gram_accumulate(*_t(A, X, p, v))
    ops.ihb_update(torch.eye(8), torch.zeros(8), 1.0, 1)
    ops.ihb_degree(torch.zeros(4, 8), torch.eye(4), torch.eye(8), 1, PSI, 4)
    assert ops.launch_counts() == before


def test_plain_border_columns_match_ref():
    A, X, p, v = _gram_inputs(4, 64, 7, 3, 11)
    want = jref.border_columns_ref(jnp.asarray(A), jnp.asarray(X), jnp.asarray(p),
                                   jnp.asarray(v))
    got = ref.border_columns_ref(*_t(A, X, p, v))
    assert np.array_equal(got.numpy(), np.asarray(want))
