"""The l1-regularized squared-hinge linear SVM of Algorithm 2, one-vs-rest,
trained by FISTA, written plainly: the step from 20 power iterations on
``[X 1]^T [X 1]``, then accelerated proximal gradient steps (soft
thresholding on ``W``, the bias unpenalized) until ``max_iter`` or until an
iteration moves ``W`` and ``b`` by at most ``tol`` (largest entry of each,
summed).  The stopping test is read every iteration."""

from __future__ import annotations

import numpy as np
import torch

from . import prec as prec_mod


def targets(y: np.ndarray):
    """The classes in sorted order and the (m, k) one-vs-rest targets."""
    classes = np.unique(y)
    return classes, np.where(np.asarray(y)[:, None] == classes[None, :], 1.0, -1.0)


def fit(X: torch.Tensor, y: np.ndarray, lam: float, max_iter: int, tol: float,
        prec: str = "fp64"):
    """FISTA on the features ``X`` (m, p), on ``X``'s device.  Returns
    ``(W (p, k), b (k,), iterations, classes)`` with ``W`` and ``b`` as
    numpy in ``prec``'s float type."""
    dt = prec_mod.dtype(prec)
    X = X.to(dt)
    dev = X.device
    classes, Yh = targets(y)
    Y = torch.as_tensor(Yh, device=dev).to(dt)
    m, p = X.shape
    k = Y.shape[1]
    Xb = torch.cat([X, X.new_ones((m, 1))], dim=1)
    v = X.new_ones((p + 1, 1))
    for _ in range(20):
        v = prec_mod.mm(Xb.T, prec_mod.mm(Xb, v, prec), prec)
        v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-30)
    lmax = (v.T @ prec_mod.mm(Xb.T, prec_mod.mm(Xb, v, prec), prec)).reshape(())
    step = 1.0 / torch.clamp(2.0 * lmax / m, min=1e-12)
    lam_t = torch.tensor(lam, dtype=dt, device=dev)
    W = X.new_zeros((p, k))
    b = X.new_zeros((k,))
    Wz, bz = W, b
    t = 1.0
    it = 0
    while it < max_iter:
        scores = prec_mod.mm(X, Wz, prec) + bz
        active = torch.clamp(1.0 - Y * scores, min=0.0)
        g = (-2.0 / m) * (active * Y)
        gW = prec_mod.mm(X.T, g, prec)
        gb = g.sum(dim=0)
        u = Wz - step * gW
        W_new = torch.sign(u) * torch.clamp(torch.abs(u) - step * lam_t, min=0.0)
        b_new = bz - step * gb
        t_new = 0.5 * (1.0 + (1.0 + 4.0 * t * t) ** 0.5)
        beta = (t - 1.0) / t_new
        Wz = W_new + beta * (W_new - W)
        bz = b_new + beta * (b_new - b)
        delta = float(torch.max(torch.abs(W_new - W)) + torch.max(torch.abs(b_new - b)))
        W, b, t = W_new, b_new, t_new
        it += 1
        if delta <= tol:
            break
    return W.cpu().numpy(), b.cpu().numpy(), it, classes


def objective(X: torch.Tensor, y: np.ndarray, W: np.ndarray, b: np.ndarray, lam: float) -> float:
    """The SVM's training objective at float64: the mean over rows of the
    summed squared hinge losses plus ``lam`` times the l1 norm of ``W``."""
    X = X.to(torch.float64)
    _, Yh = targets(y)
    Y = torch.as_tensor(Yh, device=X.device)
    Wt = torch.as_tensor(np.asarray(W, np.float64), device=X.device)
    bt = torch.as_tensor(np.asarray(b, np.float64), device=X.device)
    hinge = torch.clamp(1.0 - Y * (X @ Wt + bt), min=0.0)
    return float((hinge * hinge).sum() / X.shape[0] + lam * Wt.abs().sum())
