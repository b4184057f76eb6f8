"""The fused FISTA step (``csrc/fista_step.cu``) on the card (marker ``gpu``).

The kernel is held against the eager loop (its plain version) on the same
CUDA tensors: the same stop iteration, W and b within a stated tolerance,
steps past the stop that move no bit, two runs bit-identical, and one launch
a step issued.  Each test decides inside the ``cuda`` fixture whether a card
is present and skips with a reason when not; run them on the card with
``pytest -m gpu tests/``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import svm
from repro_torch.kernels import _build, fista_step, ops, ref

pytestmark = pytest.mark.gpu

# The kernel's gradient is the eager one summed in another order (each
# thread's rows, a shuffle tree, the warps, then the block partials in
# float64, against cuBLAS's blocking): as on the CPU
# (tests/test_torch_fista.py), a few hundred accelerated steps carry a step's
# ulps to ~1e-5 of max|W|; 10x room above.
KERNEL_TOL = 1e-4


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _data(m, p, k, device, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (m, p)).astype(np.float32)
    w = rng.standard_normal((p, k))
    labels = np.argmax(X @ w + 0.3 * rng.standard_normal((m, k)), axis=1).astype(np.int8)
    return torch.from_numpy(X).to(device), torch.from_numpy(labels).to(device)


def _scalars(X, tol):
    return (torch.tensor(1e-4, dtype=torch.float32, device=X.device), svm._step_size(X),
            torch.tensor(tol, dtype=torch.float32, device=X.device))


# the paper-scale head at a ragged edge, the widest head of each k bucket,
# and rows that are not a multiple of 16 bytes
CASES = [(100_003, 12, 2, 300, 1e-4), (100_003, 12, 2, 10_000, 2e-4),
         (100_003, 32, 2, 200, 1e-4), (50_001, 16, 4, 200, 1e-4), (50_001, 8, 8, 200, 1e-4),
         (100_003, 13, 2, 200, 1e-4), (30_001, 3, 5, 200, 1e-4), (777, 1, 1, 100, 1e-4)]


@pytest.mark.parametrize("m,p,k,max_iter,tol", CASES)
def test_fista_kernel_against_the_eager_loop(cuda, m, p, k, max_iter, tol):
    X, labels = _data(m, p, k, cuda)
    lam, step, tolt = _scalars(X, tol)
    before = ops.launch_counts()["fista_step"]
    W, b, iters = svm._fista_fused(X, labels, k, lam, step, max_iter, tolt)
    issued = ops.launch_counts()["fista_step"] - before
    i = int(iters)
    assert issued == min(max_iter, -(-i // svm.CHECK_EVERY) * svm.CHECK_EVERY)
    We, be, ie = svm._fista(X, ref.class_signs_ref(labels, k, X.dtype), lam, step, max_iter,
                            tolt)
    assert i == int(ie)
    scale = float(We.abs().max())
    torch.testing.assert_close(W, We, rtol=0, atol=KERNEL_TOL * scale)
    torch.testing.assert_close(b, be, rtol=0, atol=KERNEL_TOL * scale)
    W2, b2, iters2 = svm._fista_fused(X, labels, k, lam, step, max_iter, tolt)
    assert torch.equal(W, W2) and torch.equal(b, b2) and torch.equal(iters, iters2)


@pytest.mark.parametrize("max_iter,tol", [(50, 1e-4), (10_000, 1e-3)], ids=["max_iter", "tol"])
def test_fista_kernel_steps_past_the_stop_move_no_bit(cuda, max_iter, tol):
    X, labels = _data(100_003, 12, 2, cuda, seed=1)
    lam, step, tolt = _scalars(X, tol)
    run = fista_step.FistaStep(X, labels, 2, step, lam, tolt, max_iter)
    while bool((run.iters < max_iter) & (run.delta > tolt)):
        run.run(1)
    state, iters = run.state.clone(), run.iters.clone()
    before = ops.launch_counts()["fista_step"]
    run.run(7)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fista_step"] == before + 7
    assert torch.equal(run.state, state) and torch.equal(run.iters, iters)


def test_fista_variants_agree_with_the_library(cuda):
    lib = _build.library()
    for p in range(0, 70):
        for k in range(0, 12):
            pk = fista_step.variant(p, k)
            assert lib.repro_fista_variant(p, k) == (0 if pk is None else 100 * pk[0] + pk[1])


def test_linear_svm_on_card_takes_the_kernel(cuda):
    X, labels = _data(20_000, 6, 3, cuda, seed=2)
    y = labels.cpu().numpy()
    before = ops.launch_counts()["fista_step"]
    model = svm.LinearSVM(svm.LinearSVMConfig(max_iter=96, tol=1e-9), device=cuda).fit(
        X.cpu().numpy(), y)
    assert model.stats["iters"] == 96
    assert ops.launch_counts()["fista_step"] == before + 96


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "scalar"])
def test_fista_wrapper_raises(cuda, bad):
    X, labels = _data(1000, 4, 2, cuda)
    lam, step, tol = _scalars(X, 1e-4)
    if bad == "dtype":
        X = X.double()
    elif bad == "shape":
        labels = labels[:-1]
    elif bad == "device":
        labels = labels.cpu()
    else:
        step = step.double()
    with pytest.raises((TypeError, ValueError)):
        fista_step.FistaStep(X, labels, 2, step, lam, tol, 10)
