"""The SVM head's FISTA step on the CPU: which path a head takes, the eager
loop's bits, and the fused kernel's plain mirror held against the eager loop.

The kernel itself (``csrc/fista_step.cu``) runs only on the card
(``tests/test_torch_gpu_fista.py``); here its plain version,
:func:`repro_torch.kernels.ref.fista_step_ref`, carries its arithmetic: the
class index in place of the +-1 matrix, and the gradient's block partials
summed in block order in float64.
"""

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import svm
from repro_torch.kernels import fista_step, ref

# The mirror's gradient is the eager one summed in another order (float32
# block partials folded in float64, against one library product): a step
# moves W by a few float32 ulps, and a few hundred accelerated steps carry
# that to ~1e-5 of max|W| (2.1e-5 at most on these cases).  10x room above.
MIRROR_TOL = 1e-4


def _data(m, p, k, seed=0):
    """Features in [0, 1] and classes from a noisy linear rule."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (m, p)).astype(np.float32)
    w = rng.standard_normal((p, k))
    labels = np.argmax(X @ w + 0.3 * rng.standard_normal((m, k)), axis=1)
    return torch.from_numpy(X), torch.from_numpy(labels.astype(np.int8))


def _scalars(X, tol):
    return (torch.tensor(1e-4, dtype=torch.float32), svm._step_size(X),
            torch.tensor(tol, dtype=torch.float32))


def _fista_before(X, Y, lam, step, max_iter: int, tol):
    """The eager loop as it was before the fused kernel, kept to hold its
    bits."""
    p, k = X.shape[1], Y.shape[1]
    W = X.new_zeros((p, k))
    b = X.new_zeros((k,))
    Wz, bz = W, b
    t = X.new_ones(())
    i = torch.zeros((), dtype=torch.int32, device=X.device)
    delta = X.new_full((), float("inf"))
    while bool((i < max_iter) & (delta > tol)):
        for _ in range(svm.CHECK_EVERY):
            live = (i < max_iter) & (delta > tol)
            gW, gb = svm._squared_hinge_grad(Wz, bz, X, Y)
            u = Wz - step * gW
            W_new = torch.sign(u) * torch.clamp(torch.abs(u) - step * lam, min=0.0)
            b_new = bz - step * gb
            t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
            beta = (t - 1.0) / t_new
            Wz_new = W_new + beta * (W_new - W)
            bz_new = b_new + beta * (b_new - b)
            d_new = torch.max(torch.abs(W_new - W)) + torch.max(torch.abs(b_new - b))
            W = torch.where(live, W_new, W)
            b = torch.where(live, b_new, b)
            Wz = torch.where(live, Wz_new, Wz)
            bz = torch.where(live, bz_new, bz)
            t = torch.where(live, t_new, t)
            delta = torch.where(live, d_new, delta)
            i = i + live.to(torch.int32)
    return W, b, i


CUDA, CPU, META = torch.device("cuda"), torch.device("cpu"), torch.device("meta")


@pytest.mark.parametrize("device,dtype,p,k,fused", [
    (CUDA, torch.float32, 12, 2, True),    # the paper-scale head
    (CUDA, torch.float32, 1, 1, True),
    (CUDA, torch.float32, 32, 2, True),    # the limit's edges
    (CUDA, torch.float32, 33, 2, False),
    (CUDA, torch.float32, 16, 4, True),
    (CUDA, torch.float32, 17, 3, False),
    (CUDA, torch.float32, 8, 8, True),
    (CUDA, torch.float32, 9, 5, False),
    (CUDA, torch.float32, 1, 9, False),
    (CUDA, torch.float32, 1653, 2, False),  # a Spambase-width head
    (CUDA, torch.float64, 12, 2, False),
    (CPU, torch.float32, 12, 2, False),
    (META, torch.float32, 12, 2, False),
])
def test_the_path_a_head_takes(device, dtype, p, k, fused):
    assert fista_step.takes(device, dtype, p, k) is fused
    if device == CUDA and dtype == torch.float32:
        pk = fista_step.variant(p, k)
        assert (pk is not None) is fused
        if fused:
            pb, kb = pk
            assert p <= pb and k <= kb and pb * kb <= fista_step.ACC_LIMIT


@pytest.mark.parametrize("max_iter,tol", [(100, 1e-4), (64, 1e-4), (10_000, 3e-4), (0, 1e-4)],
                         ids=["partial_block", "whole_blocks", "tol_stop", "no_steps"])
def test_eager_loop_keeps_its_bits(max_iter, tol):
    X, labels = _data(1500, 9, 3, seed=1)
    lam, step, tolt = _scalars(X, tol)
    Y = ref.class_signs_ref(labels, 3, X.dtype)
    got = svm._fista(X, Y, lam, step, max_iter, tolt)
    want = _fista_before(X, Y, lam, step, max_iter, tolt)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cpu_fit_takes_the_eager_loop_with_the_host_targets():
    X, labels = _data(800, 6, 2, seed=2)
    y = np.array(["a", "b"])[labels.numpy()]
    Y = np.where(y[:, None] == np.unique(y)[None, :], 1.0, -1.0)
    assert torch.equal(ref.class_signs_ref(labels, 2, torch.float32),
                       torch.tensor(Y, dtype=torch.float32))
    cfg = svm.LinearSVMConfig(max_iter=70)
    model = svm.LinearSVM(cfg, device="cpu").fit(X.numpy(), y)
    lam, step, tol = (torch.tensor(cfg.lam), svm._step_size(X), torch.tensor(cfg.tol))
    W, b, i = _fista_before(X, torch.tensor(Y, dtype=torch.float32), lam, step, 70, tol)
    assert np.array_equal(model.W, W.numpy()) and np.array_equal(model.b, b.numpy())
    assert model.stats["iters"] == int(i) == 70


@pytest.mark.parametrize("m,p,k,max_iter,tol", [
    (3000, 12, 2, 100, 1e-4),     # stops at max_iter, not a multiple of 32
    (3000, 12, 2, 10_000, 1e-4),  # stops on tol inside a block (step 720)
    (2000, 7, 3, 10_000, 3e-4),   # three classes, stops on tol (step 557)
    (1001, 5, 1, 45, 1e-4),       # one class, a ragged last tile
])
def test_mirror_of_the_kernel_against_the_eager_loop(m, p, k, max_iter, tol):
    X, labels = _data(m, p, max(k, 2))
    labels = labels % k
    lam, step, tolt = _scalars(X, tol)
    W, b, i = svm._fista(X, ref.class_signs_ref(labels, k, X.dtype), lam, step, max_iter, tolt)
    Wf, bf, i_f = svm._fista_fused(X, labels, k, lam, step, max_iter, tolt)
    assert int(i_f) == int(i)
    if max_iter == 10_000:
        assert 0 < int(i) < max_iter and int(i) % svm.CHECK_EVERY
    scale = float(W.abs().max())
    torch.testing.assert_close(Wf, W, rtol=0, atol=MIRROR_TOL * scale)
    torch.testing.assert_close(bf, b, rtol=0, atol=MIRROR_TOL * scale)


@pytest.mark.parametrize("max_iter,tol", [(40, 1e-4), (10_000, 1e-3)], ids=["max_iter", "tol"])
def test_mirror_steps_past_the_stop_change_nothing(max_iter, tol):
    X, labels = _data(700, 4, 2, seed=3)
    lam, step, tolt = _scalars(X, tol)
    run = fista_step.FistaStep(X, labels, 2, step, lam, tolt, max_iter)
    while bool((run.iters < max_iter) & (run.delta > tolt)):
        run.run(1)
    before = run.state.clone(), run.iters.clone()
    run.run(5)
    assert torch.equal(run.state, before[0]) and torch.equal(run.iters, before[1])


@pytest.mark.parametrize("max_iter,blocks", [(100, [32, 32, 32, 4]), (64, [32, 32]), (0, [])])
def test_fused_loop_issues_no_step_past_max_iter(max_iter, blocks):
    X, labels = _data(500, 3, 2, seed=4)
    lam, step, tol = _scalars(X, 1e-9)
    obs.reset(metrics=False)
    _, _, iters = svm._fista_fused(X, labels, 2, lam, step, max_iter, tol)
    events = [e for e in obs.trace_events() if e.get("ph") == "X"]
    assert [e["args"]["fused"] for e in events if e["name"] == "svm/fista_block"] == blocks
    assert sum(e["name"] == "svm/stop_test" for e in events) == len(blocks) + 1
    assert int(iters) == max_iter


def test_the_state_buffer_holds_what_the_loop_returns():
    X, labels = _data(300, 3, 2, seed=5)
    lam, step, tol = _scalars(X, 1e-4)
    run = fista_step.FistaStep(X, labels, 2, step, lam, tol, 20)
    assert float(run.state[-2]) == 1.0 and float(run.delta) == float("inf")
    run.run(20)
    W, b, Wz, bz, t, delta = ref.fista_state_views(run.state, 3, 2)
    assert W.data_ptr() == run.W.data_ptr() and b.data_ptr() == run.b.data_ptr()
    assert int(run.iters) == 20 and float(t) > 1.0 and float(delta) > 0.0
    assert not torch.equal(W, Wz)


@pytest.mark.parametrize("bad", ["dtype", "shape", "p_too_wide"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(bad):
    X, labels = _data(200, 3, 2, seed=6)
    lam, step, tol = _scalars(X, 1e-4)
    k = 2
    if bad == "dtype":
        labels = labels.to(torch.int32)
    elif bad == "shape":
        labels = labels[:-1]
    else:
        X = torch.zeros((200, 40))
    with pytest.raises((TypeError, ValueError)):
        fista_step.FistaStep(X, labels, k, step, lam, tol, 10)
