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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .. import _device

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


def _soft_threshold(x, t):
    return torch.sign(x) * torch.clamp(torch.abs(x) - t, min=0.0)


def _fista(X, Y, lam, step, max_iter: int, tol):
    p, k = X.shape[1], Y.shape[1]
    W = X.new_zeros((p, k))
    b = X.new_zeros((k,))
    Wz, bz = W, b
    t = X.new_ones(())
    i = torch.zeros((), dtype=torch.int32, device=X.device)
    delta = X.new_full((), float("inf"))
    while bool((i < max_iter) & (delta > tol)):
        for _ in range(CHECK_EVERY):
            live = (i < max_iter) & (delta > tol)
            gW, gb = _squared_hinge_grad(Wz, bz, X, Y)
            W_new = _soft_threshold(Wz - step * gW, step * lam)
            b_new = bz - step * gb  # bias unpenalized
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
        dt = getattr(torch, self.config.dtype)
        dev = self.device
        X = _device.tensor(X, dt, dev)
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        Y = _device.tensor(np.where(y[:, None] == self.classes_[None, :], 1.0, -1.0),
                           dt, dev)
        # Lipschitz constant of the squared-hinge gradient: 2/m * lmax(X~^T X~)
        m = X.shape[0]
        Xb = torch.cat([X, X.new_ones((m, 1))], dim=1)
        # power iteration for the top singular value
        v = X.new_ones((Xb.shape[1],))
        for _ in range(20):
            v = Xb.T @ (Xb @ v)
            v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-30)
        lmax = v @ (Xb.T @ (Xb @ v))
        step = 1.0 / torch.clamp(2.0 * lmax / m, min=1e-12)
        W, b, iters = _fista(
            X, Y, torch.tensor(self.config.lam, dtype=dt, device=dev), step,
            self.config.max_iter, torch.tensor(self.config.tol, dtype=dt, device=dev),
        )
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
