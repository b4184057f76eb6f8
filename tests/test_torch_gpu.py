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
# the degree loop chains up to ~800 such updates on columns of condition
# number ~3 (kappa of the Gram ~10): each matvec summed in another order moves
# N by a few fp32 ulps, and the chain adds them up
DEGREE_RTOL, DEGREE_ATOL = 1e-3, 1e-4
PSI = 0.005
BAND = 1e-3  # verdicts within BAND * psi of psi may flip between sum orders


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
    """The in-place contract: a gated-off launch leaves N bit-identical, and
    a gated-on one changes only the leading (ell + 1)^2 block, in place."""
    rng = np.random.default_rng(3)
    N, q, btb, ell = _ihb_inputs(rng, 64, 20, cuda)
    ell_t = torch.tensor(ell, dtype=torch.int32, device=cuda)
    before = N.clone()
    off = torch.tensor(False, device=cuda)
    assert ops.ihb_update_(N, q, btb, ell_t, active=off) is N
    assert torch.equal(N, before)
    on = torch.tensor(True, device=cuda)
    ops.ihb_update_(N, q, btb, ell_t, active=on)
    want = ops.ihb_update(before, q, btb, ell_t, use_kernel=False)
    torch.testing.assert_close(N, want, rtol=IHB_RTOL, atol=IHB_ATOL)
    assert torch.equal(N[ell + 1:, :], before[ell + 1:, :])
    assert torch.equal(N[:, ell + 1:], before[:, ell + 1:])


def test_ihb_update_kernel_out_of_place_leaves_input(cuda):
    """With ``out`` the kernel reads N and writes only out's active block."""
    from repro_torch.kernels.ihb_update import ihb_update_

    rng = np.random.default_rng(4)
    N, q, btb, ell = _ihb_inputs(rng, 512, 300, cuda)
    ell_t = torch.tensor(ell, dtype=torch.int32, device=cuda)
    before = N.clone()
    out = N.clone()
    ihb_update_(N, q, btb, ell_t, out=out)
    assert torch.equal(N, before)
    assert torch.equal(out, ops.ihb_update(N, q, btb, ell_t))


def degree_inputs(seed, Lcap, ell0, K, appended, Kcap=None):
    """Normalized Gram blocks of one degree, as ``stats_step`` hands them to
    the candidate loop (QL transposed): ``ell0`` Gaussian columns in O (N
    their exact inverse, padded with the identity) and K candidates, of which
    those with ``appended[a]`` are independent (MSE near 1: appended) and the
    others a combination of O's columns plus noise of variance psi / 5
    (accepted).  Numpy arrays in float32."""
    rng = np.random.default_rng(seed)
    Kcap = Kcap or K
    m = 4 * (ell0 + K)
    A = rng.standard_normal((m, ell0))
    B = rng.standard_normal((m, K))
    dep = ~np.asarray(appended)
    B[:, dep] = (A @ rng.standard_normal((ell0, dep.sum())) / np.sqrt(ell0)
                 + np.sqrt(PSI / 5) * rng.standard_normal((m, dep.sum())))
    N = np.eye(Lcap)
    N[:ell0, :ell0] = np.linalg.inv(A.T @ A / m)
    QLt = np.zeros((Kcap, Lcap))
    QLt[:K, :ell0] = (A.T @ B / m).T
    C = np.zeros((Kcap, Kcap))
    C[:K, :K] = B.T @ B / m
    return [x.astype(np.float32) for x in (QLt, C, N)]


# (Lcap, ell0, K, Kcap): the wide fit's two degrees, a small one, and a
# large active block; about half the candidates are appended
_DEGREE_SHAPES = [(64, 4, 40, 64), (2048, 1, 57, 64), (2048, 58, 1653, 2048),
                  (2048, 1024, 512, 512)]


def _degree_case(cuda, Lcap, ell0, K, Kcap):
    rng = np.random.default_rng(Lcap + ell0 + K)
    appended = rng.uniform(size=K) < 0.5
    QLt, C, N = (torch.from_numpy(x).to(cuda)
                 for x in degree_inputs(K + ell0, Lcap, ell0, K, appended, Kcap))
    return QLt, C, N


@pytest.mark.parametrize("Lcap,ell0,K,Kcap", _DEGREE_SHAPES)
def test_ihb_degree_kernel_vs_plain(cuda, Lcap, ell0, K, Kcap):
    QLt, C, N0 = _degree_case(cuda, Lcap, ell0, K, Kcap)
    Nk, Np = N0.clone(), N0.clone()
    before = ops.launch_counts()["ihb_degree"]
    got = ops.ihb_degree(QLt, C, Nk, ell0, PSI, K)
    assert ops.launch_counts()["ihb_degree"] == before + 1
    want = ops.ihb_degree(QLt, C, Np, ell0, PSI, K, use_kernel=False)
    torch.cuda.synchronize()
    acc, mses, coeffs, slots, ell = got
    p_acc, p_mses, p_coeffs, p_slots, p_ell = want
    # verdicts equal up to the first candidate within BAND * psi of psi
    banded = torch.nonzero((p_mses - PSI).abs() <= BAND * PSI)
    stop = int(banded[0]) if banded.numel() else K
    assert torch.equal(acc[:stop], p_acc[:stop])
    assert torch.equal(slots[:stop], p_slots[:stop])
    assert 0.3 * K < int((~p_acc).sum()) < 0.7 * K  # about half appended
    if stop < K:
        return
    assert torch.equal(ell, p_ell.to(torch.int32))
    tol = dict(rtol=DEGREE_RTOL, atol=DEGREE_ATOL)
    torch.testing.assert_close(mses, p_mses, **tol)
    torch.testing.assert_close(coeffs, p_coeffs, **tol)
    torch.testing.assert_close(Nk, Np, **tol)
    # rows and columns past the final ell: bit-exact, never touched
    e = int(ell)
    assert torch.equal(Nk[e:, :], N0[e:, :]) and torch.equal(Nk[:, e:], N0[:, e:])


@pytest.mark.parametrize("Lcap,ell0,K,Kcap", _DEGREE_SHAPES[2:])
def test_ihb_degree_kernel_deterministic(cuda, Lcap, ell0, K, Kcap):
    """Two launches on the same inputs give the same bits (no atomics)."""
    QLt, C, N0 = _degree_case(cuda, Lcap, ell0, K, Kcap)
    N1, N2 = N0.clone(), N0.clone()
    out1 = ops.ihb_degree(QLt, C, N1, ell0, PSI, K)
    out2 = ops.ihb_degree(QLt, C, N2, ell0, PSI, K)
    assert torch.equal(N1, N2)
    for a, b in zip(out1, out2):
        assert torch.equal(a, b)


def test_ihb_degree_kernel_raises_on_bad_input(cuda):
    QLt, C, N = _degree_case(cuda, 64, 4, 40, 64)
    with pytest.raises(ValueError):  # ell0 + K > Lcap
        ops.ihb_degree(QLt, C, N, 30, PSI, 40)
    with pytest.raises(TypeError):
        ops.ihb_degree(QLt.double(), C, N, 4, PSI, 40)


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
    degrees = len(card.stats["degrees"])
    assert launches["gram_update_acc"] == degrees
    # the inverse engine's candidate loop: one launch per degree
    assert launches["ihb_degree"] == (degrees if ie == "inverse" else 0)
    assert launches["ihb_update"] == 0


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


# ---------------------------------------------------------------------------
# The convex oracles and the oracle engine on the card
# ---------------------------------------------------------------------------


def _oracle_problem(seed, device, m=200, ell=6, Lcap=8):
    """``tests/test_torch_oracles.py``'s instances, on ``device``."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(0, 1, (m, ell)).astype(np.float32)
    b = rng.uniform(0, 1, m).astype(np.float32)
    Q = np.zeros((Lcap, Lcap), np.float32)
    q = np.zeros((Lcap,), np.float32)
    Q[:ell, :ell] = A.T @ A / m
    q[:ell] = A.T @ b / m
    btb = np.float32(b @ b / m)
    mask = np.arange(Lcap) < ell
    return tuple(torch.from_numpy(np.asarray(x)).to(device) for x in (Q, q, btb, mask))


@pytest.mark.parametrize("name", ["agd", "cg", "pcg", "bpcg"])
def test_oracle_runners_bit_identical_on_card(cuda, name):
    """On CUDA tensors the chunked while runner equals the scheduled runner
    at full budget and the one-step-at-a-time loop, bit for bit."""
    from repro_torch.core import oracles

    Q, q, btb, mask = _oracle_problem(3, cuda)
    psi = torch.tensor(1e-6, device=cuda)
    cfg = oracles.OracleConfig(name=name, max_iter=512, eps_frac=1e-3, tau=1000.0)
    ref = oracles.SOLVERS[name](Q, q, btb, 1.0, mask, psi, cfg)
    sch = oracles.SCHEDULED_SOLVERS[name](Q, q, btb, 1.0, mask, psi, cfg,
                                          schedule=oracles.max_schedule(cfg))
    one = oracles._run_while(*oracles._PARTS[name](Q, q, btb, 1.0, mask, psi, cfg, None),
                             chunk=1)
    assert ref.y.device.type == "cuda" and bool(sch.converged)
    for got in (sch, one):
        assert torch.equal(ref.y, got.y) and torch.equal(ref.f, got.f)
        assert torch.equal(ref.gap, got.gap) and int(ref.iters) == int(got.iters)
    assert int(ref.iters) > oracles.WHILE_CHUNK


@pytest.mark.parametrize("n", [8, 61, 2048, 100_003])
def test_argmax_ties_first_index_on_card(cuda, n):
    """``torch.argmax`` / ``argmin`` on the card return the first of equal
    extremes, as ``jnp.argmax`` does and the FW vertex choices rely on."""
    rng = np.random.default_rng(n)
    x = rng.uniform(-1, 1, n).astype(np.float32)
    where = np.sort(rng.choice(n, size=min(n, 5), replace=False))
    x[where] = 2.0
    t = torch.from_numpy(x).to(cuda)
    assert int(torch.argmax(t)) == int(where[0])
    assert int(torch.argmin(-t)) == int(where[0])
    masked = torch.where(torch.arange(n, device=cuda) > int(where[1]), t, float("-inf"))
    assert int(torch.argmax(masked)) == int(where[2])
    assert int(torch.argmax(torch.full((n,), float("-inf"), device=cuda))) == 0


def test_fw_vertex_on_card_equals_cpu(cuda):
    from repro_torch.core import oracles

    cases = [([0.5, -0.5, 0.5, 0.1], [1, 1, 1, 1]), ([0.0, 0.0, 0.0, 0.0], [1, 1, 1, 0]),
             ([0.9, 0.2, -0.2, 0.0], [0, 1, 1, 1])]
    for grad, mask in cases:
        g = torch.tensor(grad, dtype=torch.float32)
        msk = torch.tensor(mask, dtype=torch.bool)
        i_cpu, v_cpu = oracles._fw_vertex(g, msk, 3.0)
        i_gpu, v_gpu = oracles._fw_vertex(g.to(cuda), msk.to(cuda), 3.0)
        assert int(i_gpu) == int(i_cpu) and float(v_gpu) == float(v_cpu)


def _appc_class0(m=3000):
    from repro_torch.core.transform import MinMaxScaler
    from repro_torch.data import synthetic

    X, y = synthetic.appendix_c(m=m, seed=0)
    Xtr, ytr, _, _ = synthetic.train_test_split(X, y, test_frac=0.4, seed=0)
    return MinMaxScaler(dtype="float32").fit_transform(Xtr)[ytr == 0]


# PCG / BPCG paths split at near-ties (tests/test_torch_oracles.py): held by
# the vanishing contract instead of their coefficients
_SPLITTING = ("bpcgavi-wihb", "bpcgavi", "pcgavi")


@pytest.mark.parametrize("variant,ie", [
    ("cgavi-ihb", "inverse"), ("cgavi-ihb", "chol"), ("agdavi-ihb", "inverse"),
    ("bpcgavi-wihb", "inverse"), ("bpcgavi", "inverse"), ("pcgavi", "inverse"),
    ("cgavi", "inverse"), ("agdavi", "inverse"),
])
def test_oracle_fit_on_card_matches_cpu(cuda, variant, ie):
    """Each variant on the card against the same fit on the CPU: equal
    structure; coefficients at the fast engine's tolerances (warm variants,
    whose certificates fire at the closed form) or the same-steps tolerance
    rtol 1e-4, atol 1e-5 of ``tests/test_torch_oavi.py`` (cold CG and AGD);
    PCG and BPCG generators must vanish (MSE at most psi (1 + 1e-3))."""
    from repro_torch import api

    X = _appc_class0()
    card = api.fit(X, f"oavi:{variant}", psi=PSI, inverse_engine=ie)
    cpu = api.fit(X, f"oavi:{variant}", psi=PSI, inverse_engine=ie, device="cpu")
    assert card.device.type == "cuda"
    assert card.book.terms == cpu.book.terms
    assert [g.term for g in card.generators] == [g.term for g in cpu.generators]
    assert card.num_G > 0
    if variant in _SPLITTING:
        assert float(card.mse(X).max()) <= PSI * (1 + 1e-3)
        return
    if variant.endswith("-ihb"):
        # a warm start near the certificate may take a few steps on one side
        # only (the inverse engine's fp32 spread; tests/test_torch_pipeline.py)
        tol = dict(rtol=5e-3, atol=2e-3) if ie == "inverse" else dict(rtol=1e-4, atol=1e-5)
        assert ([i == 0 for i in card.stats["solver_iters"]]
                == [i == 0 for i in cpu.stats["solver_iters"]])
    else:
        tol = dict(rtol=1e-4, atol=1e-5)
        assert card.stats["solver_iters"] == cpu.stats["solver_iters"]
    for a, b in zip(card.generators, cpu.generators):
        np.testing.assert_allclose(a.coeffs, b.coeffs, **tol)


@pytest.mark.parametrize("variant", ["cgavi-ihb", "agdavi-ihb", "bpcgavi-wihb", "cgavi"])
def test_oracle_fit_launches_single_ihb_update(cuda, variant):
    """An IHB-warm oracle fit keeps N and appends through the single
    in-place ``ihb_update`` kernel: one launch per candidate (gated on the
    device), one Gram launch per degree, no ``ihb_degree``.  A cold variant
    keeps no N and launches no IHB kernel."""
    from repro_torch import api

    X = _appc_class0()
    model = api.fit(X, f"oavi:{variant}", psi=PSI)
    launches = model.stats["kernel_launches"]
    candidates = sum(model.stats["border_sizes"])
    assert launches["gram_update_acc"] == len(model.stats["degrees"])
    assert launches["ihb_degree"] == 0
    assert launches["ihb_update"] == (candidates if variant != "cgavi" else 0)
    assert model.stats["host_reads"] >= candidates


def test_classifier_save_load_on_card(cuda, tmp_path):
    """A CGAVI-IHB classifier fitted and saved on the card, loaded into a
    fresh object on the card, predicts the same labels bit for bit."""
    from repro_torch.core.pipeline import PipelineConfig, VanishingIdealClassifier
    from repro_torch.data import synthetic

    X, y = synthetic.appendix_c(m=6000, seed=0)
    Xtr, ytr, Xte, yte = synthetic.train_test_split(X, y, seed=0)
    clf = VanishingIdealClassifier(PipelineConfig(method="cgavi-ihb")).fit(Xtr, ytr)
    clf.save(str(tmp_path / "clf"))
    again = VanishingIdealClassifier.load(str(tmp_path / "clf"))
    assert again.device.type == "cuda"
    assert all(m.device.type == "cuda" for m in again.models)
    assert np.array_equal(again.transform(Xte), clf.transform(Xte))
    assert np.array_equal(again.predict(Xte), clf.predict(Xte))
    assert clf.score(Xte, yte) > 0.8


# ---------------------------------------------------------------------------
# The fused transform's row stability (F2) and the baselines on the card
# ---------------------------------------------------------------------------


def test_feature_transform_row_stable_on_card(cuda):
    """Direct, chunked (batch sizes 1, 2, 7, 256) and single-row calls of
    ``api.feature_transform`` give the same bits on the card: a row's
    features never depend on the rows that share its call (cuBLAS changes
    the last bits with the row count, so the card sums the final product
    term by term: ``api._row_stable_product``).  The fused features agree
    with the per-model transform to fp32 rounding (rtol 1e-5, atol 1e-6)."""
    from repro_torch import api
    from repro_torch.core.transform import MinMaxScaler
    from repro_torch.data import synthetic

    X, y = synthetic.appendix_c(m=3000, seed=0)
    Xs = MinMaxScaler(dtype="float32").fit_transform(X)
    models = api.fit_classes([Xs[y == c] for c in np.unique(y)], psi=PSI)
    Z = Xs[:300]
    direct = api.feature_transform(models, Z)
    assert direct.shape == (300, sum(m.num_G for m in models))
    for bs in (1, 2, 7, 256):
        assert np.array_equal(api.feature_transform(models, Z, batch_size=bs), direct), bs
    single = np.concatenate([api.feature_transform(models, Z[i:i + 1]) for i in range(40)])
    assert np.array_equal(single, direct[:40])
    np.testing.assert_allclose(direct, np.concatenate([m.transform(Z) for m in models], axis=1),
                               rtol=1e-5, atol=1e-6)


def _plain_gram(monkeypatch):
    """Send every op of ``kernels.ops`` to its plain version, on the card."""
    monkeypatch.setattr(ops, "_kernel_path", lambda t, use_kernel: False)


def test_abm_fit_on_card_launches_gram_update(cuda, monkeypatch):
    """ABM's degree step runs hand-written kernel 3 (``gram_update``, no
    carry): one launch a degree, nothing else.  Against the same fit with
    the plain Gram on the card and against the CPU fit: equal structure, and
    coefficients within the CPU parity tolerance of
    tests/test_torch_abm_vca.py (rtol 1e-3, atol 2e-4)."""
    from repro_torch import api

    X = _appc_class0()
    card = api.fit(X, "abm", psi=PSI, cap_terms=64)
    launches = card.stats["kernel_launches"]
    assert card.device.type == "cuda"
    assert launches["gram_update"] == len(card.stats["degrees"]) > 0
    assert sum(launches.values()) == launches["gram_update"]
    assert card.stats["eigh_calls"] == sum(card.stats["border_sizes"])
    cpu = api.fit(X, "abm", psi=PSI, cap_terms=64, device="cpu")
    _plain_gram(monkeypatch)
    plain = api.fit(X, "abm", psi=PSI, cap_terms=64)
    assert plain.stats["kernel_launches"]["gram_update"] == 0
    for other in (plain, cpu):
        assert card.book.terms == other.book.terms
        assert [g.term for g in card.generators] == [g.term for g in other.generators]
        for a, b in zip(card.generators, other.generators):
            np.testing.assert_allclose(a.coeffs, b.coeffs, rtol=1e-3, atol=2e-4)


def test_abm_float64_on_card_raises(cuda):
    """The Gram kernel takes float32 only; a float64 ABM fit on the card
    raises there, as the port's OAVI fit does, rather than leaving the card."""
    from repro_torch import api

    with pytest.raises(TypeError, match="float32"):
        api.fit(_appc_class0(), "abm", cap_terms=64, dtype="float64")


def test_vca_fit_on_card_matches_cpu(cuda, tmp_path):
    """cuSOLVER's SVD against LAPACK's: equal counts per degree and |G(Z)|
    within rtol 1e-4, atol 1e-6 (the CPU parity tolerance); the card
    model's save -> load round trip gives the same bits."""
    from repro_torch import api

    X = _appc_class0()
    card = api.fit(X, "vca", psi=PSI)
    cpu = api.fit(X, "vca", psi=PSI, device="cpu")
    assert card.device.type == "cuda"
    assert [(b.num_vanishing, b.num_nonvanishing) for b in card.blocks] == \
        [(b.num_vanishing, b.num_nonvanishing) for b in cpu.blocks]
    assert card.deg1_num_vanishing == cpu.deg1_num_vanishing
    np.testing.assert_allclose(card.transform(X), cpu.transform(X), rtol=1e-4, atol=1e-6)
    card.save(str(tmp_path / "v"))
    again = api.load(str(tmp_path / "v"))
    assert again.device.type == "cuda"
    assert np.array_equal(again.transform(X), card.transform(X))


def test_polysvm_on_card_matches_cpu(cuda):
    """The same anchors and iterations as the CPU fit, and decision values
    within rtol 1e-3, atol 1e-4 (tests/test_torch_polysvm.py's tolerance)."""
    from repro_torch.core.svm import PolySVM, PolySVMConfig
    from repro_torch.core.transform import MinMaxScaler
    from repro_torch.data import synthetic

    X, y = synthetic.appendix_c(m=3000, seed=0)
    Xs = MinMaxScaler(dtype="float32").fit_transform(X)
    cfg = PolySVMConfig(lam=0.1, tol=1e-2, max_kernel_samples=500)
    card = PolySVM(cfg).fit(Xs[:1800], y[:1800])
    cpu = PolySVM(cfg, device="cpu").fit(Xs[:1800], y[:1800])
    assert np.array_equal(card.anchors, cpu.anchors)
    assert card.stats == cpu.stats
    np.testing.assert_allclose(card.decision_function(Xs[1800:]),
                               cpu.decision_function(Xs[1800:]), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("method", ["abm", "vca"])
def test_baseline_classifier_save_load_on_card(cuda, tmp_path, method):
    from repro_torch.core.pipeline import PipelineConfig, VanishingIdealClassifier
    from repro_torch.data import synthetic

    X, y = synthetic.appendix_c(m=6000, seed=0)
    Xtr, ytr, Xte, yte = synthetic.train_test_split(X, y, seed=0)
    kw = {"cap_terms": 64} if method == "abm" else {}
    clf = VanishingIdealClassifier(PipelineConfig(method=method, oavi_kw=kw)).fit(Xtr, ytr)
    clf.save(str(tmp_path / "clf"))
    again = VanishingIdealClassifier.load(str(tmp_path / "clf"))
    assert all(m.device.type == "cuda" for m in again.models)
    assert np.array_equal(again.predict(Xte), clf.predict(Xte))


# ---------------------------------------------------------------------------
# The class axis: each lane of a batched launch is its one-class call
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("border", ["gathered", "materialised"])
@pytest.mark.parametrize("path", ["fold", "partials"])
@pytest.mark.parametrize("m,L,n,K", [(1024, 70, 5, 150), (512, 40, 3, 64)])
def test_gram_batched_lanes_bit_identical(cuda, monkeypatch, m, L, n, K, path, border):
    """One launch for k = 3 classes: every lane equals the one-class call on
    that lane bit for bit, on both reductions and both border sources, and
    the plain version within the Gram tolerance; one batched launch."""
    _force(monkeypatch, path, border)
    rng = np.random.default_rng(m + L + K)
    lanes = [_gram_inputs(rng, m, L, n, K, cuda) for _ in range(3)]
    A, X, p, v = (torch.stack([lane[i] for lane in lanes]) for i in range(4))
    acc = (torch.rand(3, L, K, device=cuda), torch.rand(3, K, K, device=cuda))
    before = ops.launch_counts()
    got = ops.gram_accumulate_batched(A, X, p, v, acc)
    after = ops.launch_counts()
    assert after["gram_update_acc_batched"] == before["gram_update_acc_batched"] + 1
    assert after["gram_update_acc"] == before["gram_update_acc"]
    want = ops.gram_accumulate_batched(A, X, p, v, acc, use_kernel=False)
    for c in range(3):
        one = ops.gram_accumulate(A[c], X[c], p[c], v[c], (acc[0][c], acc[1][c]))
        assert torch.equal(got[0][c], one[0]) and torch.equal(got[1][c], one[1])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=GRAM_RTOL, atol=GRAM_ATOL)


def test_gram_batched_scratch_groups_bit_exact(cuda, monkeypatch):
    """The partials path walks each lane's row blocks in the one-class
    call's groups (scratch sized k times): grouping changes no bit."""
    rng = np.random.default_rng(11)
    lanes = [_gram_inputs(rng, 4096, 32, 4, 24, cuda) for _ in range(2)]
    A, X, p, v = (torch.stack([lane[i] for lane in lanes]) for i in range(4))
    whole = ops.gram_accumulate_batched(A, X, p, v)
    monkeypatch.setattr(gram_mod, "SCRATCH_BYTES", 3 * 4 * (32 + 24) * 24)
    grouped = ops.gram_accumulate_batched(A, X, p, v)
    for c in range(2):
        one = ops.gram_accumulate(A[c], X[c], p[c], v[c])
        for a, b, o in zip(whole, grouped, one):
            assert torch.equal(a[c], b[c]) and torch.equal(a[c], o)


# (Lcap, Kcap, lanes as (ell0, K)): a lane's blocks differ from the one-class
# call's in each case; 16 lanes with staged bands, 4 spam-wide lanes whose
# bands no longer fit shared memory, and lanes whose candidates run out early
_BATCHED_DEGREE = {
    "staged-16": (256, 128, [(50, 100)] * 14 + [(20, 0), (3, 40)]),
    "unstaged-4": (2048, 2048, [(58, 1653), (100, 1500), (40, 1653), (1, 57)]),
    "staged-2": (2048, 2048, [(58, 1653), (30, 900)]),
}


@pytest.mark.parametrize("case", list(_BATCHED_DEGREE))
def test_ihb_degree_batched_lanes_bit_identical(cuda, case):
    from repro_torch.kernels import ihb_update as ihb_kernels

    Lcap, Kcap, shapes = _BATCHED_DEGREE[case]
    k = len(shapes)
    rows_max = max(e + K for e, K in shapes)
    G = ihb_kernels.lane_blocks(rows_max, k)
    staged = {ihb_kernels.degree_staged(e, K, rows_max, k) for e, K in shapes if K}
    assert (False in staged) if case.startswith("unstaged") else staged == {True}
    ins = []
    for c, (ell0, K) in enumerate(shapes):
        appended = np.random.default_rng(c).uniform(size=max(K, 1)) < 0.5
        ins.append(degree_inputs(100 + c, Lcap, ell0, max(K, 1), appended, Kcap))
    QLt, C, N0 = (torch.from_numpy(np.stack([x[i] for x in ins])).to(cuda) for i in range(3))
    N = N0.clone()
    before = ops.launch_counts()["ihb_degree_batched"]
    got = ops.ihb_degree_batched(QLt, C, N, [e for e, _ in shapes], PSI, [K for _, K in shapes])
    assert ops.launch_counts()["ihb_degree_batched"] == before + 1
    for c, (ell0, K) in enumerate(shapes):
        if K == 0:
            assert torch.equal(N[c], N0[c]) and int(got[4][c]) == ell0
            assert not bool(got[0][c].any())
            continue
        # the one-class call takes its own (larger) grid
        assert ihb_kernels.lane_blocks(ell0 + K, 1) != G or k == 1
        Nc = N0[c].clone()
        one = ops.ihb_degree(QLt[c], C[c], Nc, ell0, PSI, K)
        for got_t, want_t in zip(got[:4], one[:4]):
            assert torch.equal(got_t[c, :K], want_t)
        assert int(got[4][c]) == int(one[4]) and torch.equal(N[c], Nc)
        assert bool((got[3][c, K:] == Lcap).all()) and not bool(got[0][c, K:].any())


@pytest.mark.parametrize("L", [64, 512, 2048])
def test_ihb_update_batched_lanes_bit_identical(cuda, L):
    """Three lanes, the middle one gated off: the active lanes equal their
    one-class updates bit for bit (the batched lanes get fewer blocks: at L =
    2048 their bands leave shared memory), the inactive lane moves no byte."""
    from repro_torch.kernels import ihb_update as ihb_kernels

    rng = np.random.default_rng(L)
    cases = [_ihb_inputs(rng, L, e, cuda) for e in (L // 2, L // 4, L - 1)]
    N0 = torch.stack([c[0] for c in cases])
    q = torch.stack([c[1] for c in cases])
    btb = torch.stack([c[2] for c in cases])
    ell = torch.tensor([c[3] for c in cases], dtype=torch.int32, device=cuda)
    active = torch.tensor([True, False, True], device=cuda)
    assert ihb_kernels.lane_blocks(L, 3) < ihb_kernels.lane_blocks(L, 1) or L == 64
    N = N0.clone()
    before = ops.launch_counts()["ihb_update_batched"]
    assert ops.ihb_update_batched_(N, q, btb, ell, active=active) is N
    assert ops.launch_counts()["ihb_update_batched"] == before + 1
    assert torch.equal(N[1], N0[1])
    for c in (0, 2):
        one = ops.ihb_update(N0[c], q[c], btb[c], ell[c])
        assert torch.equal(N[c], one)


@pytest.mark.parametrize("variant", ["fast", "cgavi-ihb", "bpcgavi-wihb"])
def test_class_batched_fit_on_card_equals_sequential(cuda, variant):
    """Equal pow2 class sizes on the card: the batched models equal the
    card's sequential fits bit for bit; the group launches the Gram kernel
    once a degree (and, on the fast engine, the degree loop once a degree),
    never the one-class entries."""
    from repro_torch import api
    from repro_torch.data import synthetic

    Xs = [np.clip(synthetic._planted_class(np.random.default_rng(c), 1024, 4,
                                           degree=2 + c % 2), 0, 1).astype(np.float32)
          for c in range(3)]
    bat = api.fit_classes(Xs, f"oavi:{variant}", psi=PSI)
    seq = api.fit_classes(Xs, f"oavi:{variant}", psi=PSI, class_batch="off")
    for b, s in zip(bat, seq):
        assert b.book.terms == s.book.terms
        assert [g.term for g in b.generators] == [g.term for g in s.generators]
        for gb, gs in zip(b.generators, s.generators):
            assert np.array_equal(gb.coeffs, gs.coeffs) and gb.mse == gs.mse
    launches = bat[0].stats["kernel_launches"]
    degrees = max(len(m.stats["degrees"]) for m in bat)
    assert launches["gram_update_acc_batched"] == degrees
    assert launches["gram_update_acc"] == 0 and launches["ihb_update"] == 0
    assert launches["ihb_degree_batched"] == (degrees if variant == "fast" else 0)
    if variant == "cgavi-ihb":
        assert launches["ihb_update_batched"] > 0


# ---------------------------------------------------------------------------
# Out-of-core and incremental OAVI on the card
# ---------------------------------------------------------------------------


def _bit_equal_models(a, b):
    assert a.book.terms == b.book.terms
    assert [g.term for g in a.generators] == [g.term for g in b.generators]
    for ga, gb in zip(a.generators, b.generators):
        assert np.array_equal(ga.coeffs, gb.coeffs) and ga.mse == gb.mse, ga.term


def _planted_stream(m, seed=0):
    from repro_torch.data import synthetic
    from repro_torch.streaming import ScaledSource, StreamingMinMaxScaler

    raw = synthetic.planted_source(m, n=3, seed=seed)
    return ScaledSource(raw, StreamingMinMaxScaler(dtype="float32").fit_source(raw, 4096))


@pytest.mark.parametrize("chunk_rows", [256, 1024, 4096])
@pytest.mark.parametrize("variant", ["fast", "cgavi-ihb"])
def test_streamed_fit_on_card_equals_in_memory(cuda, variant, chunk_rows):
    """The streamed fit on the card equals the card's in-memory fit bit for
    bit, launching the one-class Gram kernel once per chunk per degree."""
    from repro_torch import api

    src = _planted_stream(20_000)
    X = src.read(0, src.num_rows)
    ref = api.fit(X, f"oavi:{variant}", psi=PSI)
    model = api.fit(src, f"oavi:{variant}", psi=PSI, chunk_rows=chunk_rows)
    _bit_equal_models(model, ref)
    st = model.stats
    assert st["streaming"]["num_chunks"] == len(st["degrees"]) * -(-20_000 // chunk_rows)
    assert st["kernel_launches"]["gram_update_acc"] == st["streaming"]["num_chunks"]
    if variant == "fast":
        assert st["kernel_launches"]["ihb_degree"] == len(st["degrees"])


@pytest.mark.parametrize("m,L,n,K,chunk_rows", [
    (16_384, 64, 3, 64, 4096),    # a paper-scale degree: partials path
    (16_384, 64, 3, 64, 256),
    (2_048, 1280, 57, 1280, 256),  # wide: the in-block fold
])
def test_gram_carry_chain_at_streaming_shapes(cuda, m, L, n, K, chunk_rows):
    """A chain of carried calls at the streamed fit's chunk shapes equals
    one call bit for bit, on the path the wrapper picks, and the plain
    version within the Gram tolerance."""
    rng = np.random.default_rng(m + chunk_rows)
    A, X, p, v = _gram_inputs(rng, m, L, n, K, cuda)
    whole = ops.gram_accumulate(A, X, p, v)
    acc = (torch.zeros(L, K, device=cuda), torch.zeros(K, K, device=cuda))
    before = ops.launch_counts()["gram_update_acc"]
    for lo in range(0, m, chunk_rows):
        acc = ops.gram_accumulate(A[lo:lo + chunk_rows], X[lo:lo + chunk_rows], p, v, acc=acc)
    assert ops.launch_counts()["gram_update_acc"] == before + m // chunk_rows
    for a, b in zip(acc, whole):
        assert torch.equal(a, b)
    want = ops.gram_accumulate(A, X, p, v, use_kernel=False)
    for g, w in zip(acc, want):
        torch.testing.assert_close(g, w, rtol=GRAM_RTOL, atol=GRAM_ATOL)


def test_online_update_on_card_equals_refit(cuda, tmp_path):
    """online.fit on a prefix, then update with the rest (and from a saved
    and loaded state): the streamed refit's bits, on the card."""
    from repro_torch import api, online
    from repro_torch.data import synthetic
    from repro_torch.streaming import ScaledSource

    src = _planted_stream(40_000, seed=1)
    prefix = ScaledSource(synthetic.planted_source(37_501, n=3, seed=1), src.scaler)
    model0 = api.fit(prefix, "oavi:fast", psi=PSI, chunk_rows=4096, capture_state=True)
    res = api.update(model0, model0.fit_state, src)
    ref = api.fit(src, "oavi:fast", psi=PSI, chunk_rows=4096)
    _bit_equal_models(res.model, ref)
    assert res.stats["folded_degrees"] == len(model0.fit_state.records)
    model0.fit_state.save(str(tmp_path / "state"))
    again = api.update(model0, online.FitState.load(str(tmp_path / "state")), src)
    _bit_equal_models(again.model, ref)


@pytest.mark.parametrize("variant", ["fast", "bpcgavi-wihb"])
def test_streamed_fit_classes_on_card(cuda, variant):
    """The class-batched streamed fit on the card: each class equals its own
    streamed fit bit for bit; one statistics step per degree for the group."""
    from repro_torch import api

    Xs = [_planted_stream(m, seed=10 + i).read(0, m) for i, m in enumerate((3000, 5000, 1200))]
    bat = api.fit_classes(Xs, f"oavi:{variant}", psi=PSI, chunk_rows=1024)
    for X, b in zip(Xs, bat):
        _bit_equal_models(b, api.fit(X, f"oavi:{variant}", psi=PSI, chunk_rows=1024))
    launches = bat[0].stats["kernel_launches"]
    degrees = max(len(m.stats["degrees"]) for m in bat)
    assert launches["gram_update_acc"] == sum(m.stats["streaming"]["num_chunks"] for m in bat)
    assert launches["gram_update_acc_batched"] == 0
    if variant == "fast":
        assert launches["ihb_degree_batched"] == degrees and launches["ihb_degree"] == 0
