"""The port's CUDA kernels and fit on the card (marker ``gpu``).

Each test decides inside the ``cuda`` fixture whether a card is present and
skips with a reason when not; run them on the card with
``pytest -m gpu tests/``.  Kernels are held against their plain PyTorch
versions on the same CUDA tensors.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import gram_update as gram_mod
from repro_torch.kernels import ops

pytestmark = pytest.mark.gpu

# fp32 sums of the same products in another order (sequential FMA over a
# block's rows vs the library's blocked product); entries are sums of
# non-negative terms, so the relative error stays near sqrt(rows) * 2^-24
GRAM_RTOL, GRAM_ATOL = 1e-5, 1e-5
# the IHB update divides by the Schur complement, which amplifies the matvec's
# rounding; same tolerance as the CPU parity test of the update
IHB_RTOL, IHB_ATOL = 1e-4, 1e-5


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    # the plain versions' products in full fp32, as the kernels compute them
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _gram_inputs(rng, m, L, n, K, device):
    A = torch.from_numpy(rng.uniform(0, 1, (m, L)).astype(np.float32)).to(device)
    X = torch.from_numpy(rng.uniform(0, 1, (m, n)).astype(np.float32)).to(device)
    p = torch.from_numpy(rng.integers(0, L, K)).to(device)
    v = torch.from_numpy(rng.integers(0, n, K)).to(device)
    return A, X, p, v


@pytest.mark.parametrize("m,L,n,K", [
    (256, 8, 3, 8),
    (777, 12, 5, 9),
    (1000, 16, 3, 32),
    (4096, 64, 3, 64),
    (2304, 130, 57, 70),
])
def test_gram_accumulate_kernel_vs_plain(cuda, m, L, n, K):
    rng = np.random.default_rng(m + L + K)
    A, X, p, v = _gram_inputs(rng, m, L, n, K, cuda)
    acc = (torch.rand(L, K, device=cuda), torch.rand(K, K, device=cuda))
    before = ops.launch_counts()["gram_update_acc"]
    got = ops.gram_accumulate(A, X, p, v, acc)
    assert ops.launch_counts()["gram_update_acc"] == before + 1
    want = ops.gram_accumulate(A, X, p, v, acc, use_kernel=False)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=GRAM_RTOL, atol=GRAM_ATOL)


@pytest.mark.parametrize("split_blocks", [1, 3, 7])
def test_gram_accumulate_kernel_chunk_invariance(cuda, split_blocks):
    rng = np.random.default_rng(split_blocks)
    m, L, n, K = 2560, 64, 3, 48
    A, X, p, v = _gram_inputs(rng, m, L, n, K, cuda)
    whole = ops.gram_accumulate(A, X, p, v)
    s = split_blocks * ops.GRAM_BLOCK
    first = ops.gram_accumulate(A[:s], X[:s], p, v)
    chained = ops.gram_accumulate(A[s:], X[s:], p, v, acc=first)
    for a, b in zip(whole, chained):
        assert torch.equal(a, b)


def test_gram_accumulate_kernel_scratch_groups_bit_exact(cuda, monkeypatch):
    """Walking the row blocks in scratch-sized groups changes no bit."""
    rng = np.random.default_rng(5)
    A, X, p, v = _gram_inputs(rng, 4096, 32, 4, 24, cuda)
    whole = ops.gram_accumulate(A, X, p, v)
    monkeypatch.setattr(gram_mod, "SCRATCH_BYTES", 3 * 4 * (32 + 24) * 24)
    grouped = ops.gram_accumulate(A, X, p, v)
    for a, b in zip(whole, grouped):
        assert torch.equal(a, b)


def _force(monkeypatch, path, border):
    """Pin the Gram kernel's reduction path and its border-column source."""
    monkeypatch.setattr(gram_mod, "FOLD_MIN_TILES", 0 if path == "fold" else 10**9)
    monkeypatch.setattr(gram_mod, "GATHER_BORDERS", border == "gathered")


# L and K off the 128-column tile grid, K > L, and K <= 64 (the narrow tile)
_RAGGED = [(1024, 70, 5, 150), (768, 200, 9, 130), (512, 40, 3, 64), (512, 129, 4, 1)]


@pytest.mark.parametrize("border", ["gathered", "materialised"])
@pytest.mark.parametrize("path", ["fold", "partials"])
@pytest.mark.parametrize("m,L,n,K", _RAGGED)
def test_gram_paths_vs_plain(cuda, monkeypatch, m, L, n, K, path, border):
    """Both reductions, with the border columns gathered in the load or
    materialised first, against the plain version; the carry's own lower
    triangle is folded into C's lower triangle."""
    _force(monkeypatch, path, border)
    assert gram_mod.path(L, K, cuda) == path
    rng = np.random.default_rng(m + L * K)
    A, X, p, v = _gram_inputs(rng, m, L, n, K, cuda)
    acc = (torch.rand(L, K, device=cuda), torch.rand(K, K, device=cuda))
    got = ops.gram_accumulate(A, X, p, v, acc)
    want = ops.gram_accumulate(A, X, p, v, acc, use_kernel=False)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=GRAM_RTOL, atol=GRAM_ATOL)


@pytest.mark.parametrize("m,L,n,K", _RAGGED)
def test_gram_paths_bit_identical(cuda, monkeypatch, m, L, n, K):
    """The in-block fold and the partials + fold pass sum the same products
    in the same order, gathered or materialised: the same bits, and C's Gram
    part exactly symmetric."""
    rng = np.random.default_rng(7 * m + K)
    A, X, p, v = _gram_inputs(rng, m, L, n, K, cuda)
    outs = []
    for path in ("fold", "partials"):
        for border in ("gathered", "materialised"):
            _force(monkeypatch, path, border)
            outs.append(ops.gram_accumulate(A, X, p, v))
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)
    C = outs[0][1]
    assert torch.equal(C, C.T)


@pytest.mark.parametrize("m,L,n,K,split_blocks", [
    (2560, 64, 3, 48, 3),        # one output tile: partials
    (768, 1280, 57, 1280, 1),    # 155 output tiles: the in-block fold
])
def test_gram_chunk_invariance_each_path(cuda, m, L, n, K, split_blocks):
    """Chunk invariance bit for bit on each side of the path threshold, with
    the path the wrapper picks by itself."""
    rng = np.random.default_rng(K + split_blocks)
    A, X, p, v = _gram_inputs(rng, m, L, n, K, cuda)
    want_path = "fold" if K == 1280 else "partials"
    assert gram_mod.path(L, K, cuda) == want_path
    acc = (torch.rand(L, K, device=cuda), torch.rand(K, K, device=cuda))
    whole = ops.gram_accumulate(A, X, p, v, acc)
    s = split_blocks * ops.GRAM_BLOCK
    first = ops.gram_accumulate(A[:s], X[:s], p, v, acc)
    chained = ops.gram_accumulate(A[s:], X[s:], p, v, acc=first)
    for a, b in zip(whole, chained):
        assert torch.equal(a, b)
    want = ops.gram_accumulate(A, X, p, v, acc, use_kernel=False)
    for g, w in zip(whole, want):
        torch.testing.assert_close(g, w, rtol=GRAM_RTOL, atol=GRAM_ATOL)


@pytest.mark.parametrize("m,L,n,K", [(1000, 16, 3, 32), (1536, 64, 8, 40)])
def test_gram_update_kernel_vs_plain(cuda, m, L, n, K):
    rng = np.random.default_rng(m * 3 + K)
    A, X, p, v = _gram_inputs(rng, m, L, n, K, cuda)
    before = ops.launch_counts()["gram_update"]
    got = ops.gram_update(A, X, p, v, bm=512)
    assert ops.launch_counts()["gram_update"] == before + 1
    want = ops.gram_update(A, X, p, v, use_kernel=False)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=GRAM_RTOL, atol=GRAM_ATOL)


def _ihb_inputs(rng, L, ell, device):
    # well-conditioned columns (Gaussian, 8 rows per column): the comparison
    # then measures the kernel, not a Schur complement near cancellation
    m = 8 * ell
    Araw = rng.standard_normal((m, ell))
    G = Araw.T @ Araw / m
    N = np.eye(L, dtype=np.float32)
    N[:ell, :ell] = np.linalg.inv(G)
    b = rng.standard_normal(m)
    q = np.zeros(L, np.float32)
    q[:ell] = Araw.T @ b / m
    btb = np.float32(b @ b / m)
    return (torch.from_numpy(N).to(device), torch.from_numpy(q).to(device),
            torch.tensor(btb, device=device), ell)


@pytest.mark.parametrize("L,ell", [(8, 3), (64, 1), (64, 40), (512, 300)])
def test_ihb_update_kernel_vs_plain(cuda, L, ell):
    rng = np.random.default_rng(L + ell)
    N, q, btb, ell = _ihb_inputs(rng, L, ell, cuda)
    ell_t = torch.tensor(ell, dtype=torch.int32, device=cuda)
    before = ops.launch_counts()["ihb_update"]
    got = ops.ihb_update(N, q, btb, ell_t)
    assert ops.launch_counts()["ihb_update"] == before + 1
    want = ops.ihb_update(N, q, btb, ell_t, use_kernel=False)
    torch.testing.assert_close(got, want, rtol=IHB_RTOL, atol=IHB_ATOL)
    # the identity padding beyond ell is untouched, bit for bit
    assert torch.equal(got[ell + 1:, ell + 1:], N[ell + 1:, ell + 1:])
    assert torch.equal(got[ell, ell + 1:], torch.zeros_like(got[ell, ell + 1:]))


def test_ihb_update_kernel_inactive_is_copy(cuda):
    rng = np.random.default_rng(3)
    N, q, btb, ell = _ihb_inputs(rng, 64, 20, cuda)
    off = torch.tensor(False, device=cuda)
    got = ops.ihb_update(N, q, btb, ell, active=off)
    assert torch.equal(got, N) and got.data_ptr() != N.data_ptr()


def test_kernels_raise_on_bad_input(cuda):
    A = torch.zeros(300, 8, device=cuda)  # not a multiple of bm
    X = torch.zeros(300, 3, device=cuda)
    p = torch.zeros(4, dtype=torch.long, device=cuda)
    with pytest.raises(ValueError):
        gram_mod.gram_update_acc(A, X, p, p, bm=256)
    with pytest.raises(TypeError):
        ops.gram_accumulate(A.double(), X.double(), p, p)


def _planted(m, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (m, 4))
    X[:, 3] = np.clip(X[:, 0] * X[:, 1] + rng.normal(0, 0.01, m), 0, 1)
    return X


@pytest.mark.parametrize("ie", ["inverse", "chol"])
def test_fit_on_card_matches_cpu(cuda, ie):
    """The default device is the card; its fit equals the CPU fit in
    structure, coefficients within the inverse engine's fp32 tolerance
    (see tests/test_torch_oavi.py)."""
    from repro_torch import api

    X = _planted(5000)
    card = api.fit(X, psi=0.005, inverse_engine=ie)
    cpu = api.fit(X, psi=0.005, inverse_engine=ie, device="cpu")
    assert card.device.type == "cuda"
    assert card.book.terms == cpu.book.terms
    assert [g.term for g in card.generators] == [g.term for g in cpu.generators]
    for a, b in zip(card.generators, cpu.generators):
        np.testing.assert_allclose(a.coeffs, b.coeffs, rtol=5e-3, atol=2e-3)
    launches = card.stats["kernel_launches"]
    assert launches["gram_update_acc"] == len(card.stats["degrees"])
    # one launch per candidate: the append is gated on the device, not skipped
    candidates = sum(card.stats["border_sizes"])
    assert launches["ihb_update"] == (candidates if ie == "inverse" else 0)


def test_classifier_on_card_matches_cpu(cuda):
    from repro_torch.core.pipeline import PipelineConfig, VanishingIdealClassifier
    from repro_torch.data import synthetic

    X, y = synthetic.appendix_c(m=6000, seed=0)
    Xtr, ytr, Xte, yte = synthetic.train_test_split(X, y, seed=0)
    card = VanishingIdealClassifier(PipelineConfig()).fit(Xtr, ytr)
    cpu = VanishingIdealClassifier(PipelineConfig(), device="cpu").fit(Xtr, ytr)
    for a, b in zip(card.models, cpu.models):
        assert [g.term for g in a.generators] == [g.term for g in b.generators]
    np.testing.assert_allclose(card.transform(Xte), cpu.transform(Xte),
                               rtol=5e-3, atol=2e-3)
    assert abs(card.score(Xte, yte) - cpu.score(Xte, yte)) <= 0.01
