"""The SVMs of the classification pipeline (Algorithm 2) and of Table 3.

Counterpart of ``src/repro/core/svm.py``:

* :class:`LinearSVM`: an l1-regularized squared-hinge linear SVM,
  one-vs-rest, trained with FISTA (accelerated proximal gradient; the l1
  prox is soft-thresholding) -- the paper's downstream classifier for the
  OAVI/ABM/VCA transforms ("l1-penalized squared hinge loss", Section 6.1).
* :class:`PolySVM`: the polynomial-kernel SVM baseline of Table 3, l2
  regularized, one-vs-rest, trained in the kernelized primal by accelerated
  gradient descent on the coefficients of a kernel expansion over at most
  ``max_kernel_samples`` anchor rows (a uniform subsample beyond that,
  drawn exactly as the reference draws it).

The reference runs each training loop as one ``lax.while_loop``.  Here a
loop runs on the device in chunks of :data:`CHECK_EVERY` iterations and the
host reads the stopping test once per chunk; an iteration past the stop is
masked to a no-op, so the result is that of the plain while-loop.

``LinearSVM``'s FISTA step takes one of two paths, by what its input shows:
a float32 head on the card whose ``p`` features and ``k`` classes fit the
kernel (:func:`repro_torch.kernels.fista_step.takes`) runs each step as one
launch of the hand-written kernel ``csrc/fista_step.cu`` (:func:`_fista_fused`,
the rows' class indices in place of the +-1 matrix); every other head (the
CPU, float64, wide heads) runs the eager step (:func:`_fista`), whose bits
are those of the plain loop.

``LinearSVM.fit`` records its phases as :mod:`repro_torch.obs` spans (inside
the pipeline's ``svm/fit``): ``svm/upload`` (features and labels to the
device), ``svm/power`` (the power iteration, as the host launches it: nothing
waits for it there), ``svm/fista`` (the whole loop) and ``svm/download`` (W,
b and the step count to the host).  Inside ``svm/fista`` each host read of
the stopping test is an ``svm/stop_test`` (the host blocked on the device)
and each chunk's launching an ``svm/fista_block`` (arg ``fused``: the chunk's
steps issued through the kernel, 0 on the eager path); no span sits inside a
chunk, and none synchronizes the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .. import _device, obs
from ..kernels import fista_step, ref

# FISTA iterations between host reads of the stopping test
CHECK_EVERY = 32


@dataclasses.dataclass(frozen=True)
class LinearSVMConfig:
    lam: float = 1e-4  # l1 penalty
    max_iter: int = 10_000
    tol: float = 1e-4
    dtype: str = "float32"


def _squared_hinge_grad(W, b, X, Y):
    """Gradients of the mean squared-hinge loss.  Y in {-1, +1}, (m, k)."""
    m = X.shape[0]
    scores = X @ W + b  # (m, k)
    active = torch.clamp(1.0 - Y * scores, min=0.0)
    g_scores = (-2.0 / m) * (active * Y)  # (m, k)
    return X.T @ g_scores, torch.sum(g_scores, dim=0)


def _step_size(X):
    """FISTA's step, 1 / L, with L = 2/m * lmax(X~^T X~) the Lipschitz
    constant of the squared-hinge gradient (X~ = [X, 1]), lmax by 20 steps of
    power iteration.  A 0-d tensor on X's device: nothing waits for it."""
    m = X.shape[0]
    Xb = torch.cat([X, X.new_ones((m, 1))], dim=1)
    v = X.new_ones((Xb.shape[1],))
    for _ in range(20):
        v = Xb.T @ (Xb @ v)
        v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-30)
    lmax = v @ (Xb.T @ (Xb @ v))
    return 1.0 / torch.clamp(2.0 * lmax / m, min=1e-12)


def _fista(X, Y, lam, step, max_iter: int, tol):
    """The eager FISTA loop (the plain version of the fused step)."""
    p, k = X.shape[1], Y.shape[1]
    W = X.new_zeros((p, k))
    b = X.new_zeros((k,))
    Wz, bz = W, b
    t = X.new_ones(())
    i = torch.zeros((), dtype=torch.int32, device=X.device)
    delta = X.new_full((), float("inf"))
    while True:
        with obs.span("svm/stop_test"):
            go = bool((i < max_iter) & (delta > tol))
        if not go:
            break
        with obs.span("svm/fista_block", fused=0):
            for _ in range(CHECK_EVERY):
                live = (i < max_iter) & (delta > tol)
                gW, gb = _squared_hinge_grad(Wz, bz, X, Y)
                W_new, b_new, Wz_new, bz_new, t_new, d_new = ref.fista_update_ref(
                    W, b, Wz, bz, t, gW, gb, step, lam)
                W = torch.where(live, W_new, W)
                b = torch.where(live, b_new, b)
                Wz = torch.where(live, Wz_new, Wz)
                bz = torch.where(live, bz_new, bz)
                t = torch.where(live, t_new, t)
                delta = torch.where(live, d_new, delta)
                i = i + live.to(torch.int32)
    return W, b, i


def _fista_fused(X, labels, k: int, lam, step, max_iter: int, tol):
    """The FISTA loop of :func:`_fista`, one launch of the fused kernel a
    step (its plain version on CPU tensors), over the rows' class indices
    ``labels`` (int8) in place of the +-1 matrix.  No block issues a step past
    ``max_iter``."""
    run = fista_step.FistaStep(X, labels, k, step, lam, tol, max_iter)
    issued = 0
    while True:
        with obs.span("svm/stop_test"):
            go = bool((run.iters < max_iter) & (run.delta > tol))
        if not go:
            break
        n = min(CHECK_EVERY, max_iter - issued)
        with obs.span("svm/fista_block", fused=n):
            run.run(n)
        issued += n
    return run.W, run.b, run.iters


class LinearSVM:
    """One-vs-rest l1 squared-hinge linear SVM.  ``device=None`` means the
    CUDA card."""

    def __init__(self, config: LinearSVMConfig = LinearSVMConfig(), device=None):
        self.config = config
        self.device = _device.resolve(device)
        self.W: Optional[np.ndarray] = None
        self.b: Optional[np.ndarray] = None
        self.classes_: Optional[np.ndarray] = None
        self.stats: Dict = {}

    def fit(self, X, y) -> "LinearSVM":
        cfg = self.config
        dt = getattr(torch, cfg.dtype)
        dev = self.device
        with obs.span("svm/upload"):
            X = _device.tensor(X, dt, dev)
            y = np.asarray(y)
            self.classes_ = np.unique(y)
            k = len(self.classes_)
            fused = fista_step.takes(X.device, X.dtype, X.shape[1], k)
            if fused:  # each row's class index, one byte
                X = X.contiguous()
                labels = _device.tensor(np.searchsorted(self.classes_, y), torch.int8, dev)
            else:
                Y = _device.tensor(np.where(y[:, None] == self.classes_[None, :], 1.0, -1.0),
                                   dt, dev)
            lam = torch.tensor(cfg.lam, dtype=dt, device=dev)
            tol = torch.tensor(cfg.tol, dtype=dt, device=dev)
        with obs.span("svm/power"):
            step = _step_size(X)
        with obs.span("svm/fista"):
            if fused:
                W, b, iters = _fista_fused(X, labels, k, lam, step, cfg.max_iter, tol)
            else:
                W, b, iters = _fista(X, Y, lam, step, cfg.max_iter, tol)
        with obs.span("svm/download"):
            self.W, self.b = W.cpu().numpy(), b.cpu().numpy()
            self.stats = {"iters": int(iters), "nnz": int((np.abs(self.W) > 0).sum())}
        return self

    def decision_function(self, X) -> np.ndarray:
        return np.asarray(X) @ self.W + self.b

    def predict(self, X) -> np.ndarray:
        return self.classes_[np.argmax(self.decision_function(X), axis=1)]

    def score(self, X, y) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y)))


# ---------------------------------------------------------------------------
# Polynomial-kernel SVM (l2, squared hinge, kernelized primal)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PolySVMConfig:
    degree: int = 3
    coef0: float = 1.0
    gamma: float = 1.0
    lam: float = 1e-3  # l2 penalty
    max_iter: int = 10_000
    tol: float = 1e-3
    max_kernel_samples: int = 4096
    dtype: str = "float32"
    seed: int = 0


def _poly_kernel(Xa, Xb, gamma, coef0, degree):
    """``(gamma * Xa Xb^T + coef0) ** degree``: one plain product (the
    reference computes it outside any Pallas kernel too)."""
    return (gamma * (Xa @ Xb.T) + coef0) ** degree


def _kernel_agd(K, Y, lam, step, max_iter: int, tol):
    """Accelerated GD on f(alpha) = mean squared hinge(K alpha) + lam |alpha|^2
    over the (m, r) cross-kernel ``K``.  Stops on the *relative* gradient
    norm (``||g||_inf <= tol * ||g_0||_inf``).  Returns ``(A, iters)``."""
    r, k = K.shape[1], Y.shape[1]
    m = Y.shape[0]

    def grad(Az):
        scores = K @ Az  # (m, k)
        margin = torch.clamp(1.0 - Y * scores, min=0.0)
        g_scores = (-2.0 / m) * (margin * Y)
        return K.T @ g_scores + 2.0 * lam * Az

    A = K.new_zeros((r, k))
    Az = A
    g0 = torch.max(torch.abs(grad(A)))
    t = K.new_ones(())
    i = torch.zeros((), dtype=torch.int32, device=K.device)
    gnorm = K.new_full((), float("inf"))
    while bool((i < max_iter) & (gnorm > tol * g0)):
        for _ in range(CHECK_EVERY):
            live = (i < max_iter) & (gnorm > tol * g0)
            g = grad(Az)
            A_new = Az - step * g
            t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
            Az_new = A_new + ((t - 1.0) / t_new) * (A_new - A)
            A = torch.where(live, A_new, A)
            Az = torch.where(live, Az_new, Az)
            t = torch.where(live, t_new, t)
            gnorm = torch.where(live, torch.max(torch.abs(g)), gnorm)
            i = i + live.to(torch.int32)
    return A, i


class PolySVM:
    """One-vs-rest polynomial-kernel SVM.  ``device=None`` means the CUDA
    card; the anchors and coefficients are kept as host numpy."""

    def __init__(self, config: PolySVMConfig = PolySVMConfig(), device=None):
        self.config = config
        self.device = _device.resolve(device)
        self.anchors: Optional[np.ndarray] = None
        self.A: Optional[np.ndarray] = None
        self.classes_: Optional[np.ndarray] = None
        self.stats: Dict = {}

    def _kernel(self, X) -> torch.Tensor:
        cfg = self.config
        dt = getattr(torch, cfg.dtype)
        return _poly_kernel(_device.tensor(X, dt, self.device),
                            _device.tensor(self.anchors, dt, self.device),
                            cfg.gamma, cfg.coef0, cfg.degree)

    def fit(self, X, y) -> "PolySVM":
        cfg = self.config
        dt = getattr(torch, cfg.dtype)
        dev = self.device
        X = np.asarray(X)
        y = np.asarray(y)
        m = X.shape[0]
        rng = np.random.default_rng(cfg.seed)
        if m > cfg.max_kernel_samples:
            idx = rng.choice(m, cfg.max_kernel_samples, replace=False)
            self.anchors = X[idx]
            self.stats["subsampled"] = True
        else:
            self.anchors = X
            self.stats["subsampled"] = False
        self.classes_ = np.unique(y)
        Y = _device.tensor(np.where(y[:, None] == self.classes_[None, :], 1.0, -1.0),
                           dt, dev)
        K = self._kernel(X)
        # step from the Lipschitz constant 2 lmax(K^T K)/m + 2 lam lmax(K)
        v = K.new_ones((K.shape[1],))
        for _ in range(20):
            v = K.T @ (K @ v)
            v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-30)
        lmax = v @ (K.T @ (K @ v))
        L = 2.0 * lmax / m + 2.0 * cfg.lam * torch.sqrt(lmax)
        step = 1.0 / torch.clamp(L, min=1e-12)
        A, iters = _kernel_agd(K, Y, torch.tensor(cfg.lam, dtype=dt, device=dev), step,
                               cfg.max_iter, torch.tensor(cfg.tol, dtype=dt, device=dev))
        self.A = A.cpu().numpy()
        self.stats["iters"] = int(iters)
        return self

    def decision_function(self, X) -> np.ndarray:
        K = self._kernel(X)
        return (K @ torch.as_tensor(self.A, device=self.device)).cpu().numpy()

    def predict(self, X) -> np.ndarray:
        return self.classes_[np.argmax(self.decision_function(X), axis=1)]

    def score(self, X, y) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y)))
