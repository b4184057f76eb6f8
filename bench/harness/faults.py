"""Faults planted under the timed path, for the check that each one makes
``correct`` come out false: a step that returns its state unchanged, half
of the batch left out with the mean taken over the rest, an answer altered
where it is produced, and a decision turned the wrong way.  Each takes an
object with pytest's ``MonkeyPatch.setattr`` and patches the program's
functions where both the CPU's path and the card's pass through them.
``bench/tests/test_bench_faults.py`` plants them at a small size on the
CPU; ``bench/tools/control.py --faults`` at a cell's own size on the card.
"""

from __future__ import annotations

import numpy as np


def ihb_state_unchanged(mp):
    """The candidate loop leaves the inverse (Theorem 4.9) as it found it."""
    import repro_torch.kernels.ops as kops

    inner = kops.ihb_degree_batched
    mp.setattr(kops, "ihb_degree_batched",
               lambda QLt, C, N, ell0s, psi, Ks, **kw: inner(QLt, C, N.clone(), ell0s, psi,
                                                             Ks, **kw))


def gram_half_batch(mp):
    """The Gram kernel sums the first half of the rows, doubled."""
    import repro_torch.kernels.ops as kops

    inner = kops.gram_accumulate_batched

    def half(A, X, parents, vars_, acc=None, **kw):
        keep = A.shape[1] // 2
        A, X = A.clone(), X.clone()
        A[:, keep:] = 0.0
        X[:, keep:] = 0.0
        ql, c = inner(A, X, parents, vars_, acc, **kw)
        return 2.0 * ql, 2.0 * c

    mp.setattr(kops, "gram_accumulate_batched", half)


def coefficient_altered(mp):
    """The last generator of each degree gets 0.01 added to its coefficients."""
    import repro_torch.core.oavi as oavi

    inner = oavi.collect_degree

    def collect(book, border, accepted, mses, coeffs, generators):
        ell = inner(book, border, accepted, mses, coeffs, generators)
        if generators:
            g = generators[-1]
            generators[-1] = g._replace(coeffs=g.coeffs + np.float32(0.01))
        return ell

    mp.setattr(oavi, "collect_degree", collect)


def decision_flipped(mp):
    """Each degree's first vanishing candidate extends the term book instead
    of becoming a generator."""
    import repro_torch.core.oavi as oavi

    inner = oavi.collect_degree

    def collect(book, border, accepted, mses, coeffs, generators):
        acc = np.array(accepted, dtype=bool)
        hits = np.flatnonzero(acc[:len(border)])
        if hits.size:
            acc[hits[0]] = False
        return inner(book, border, acc, mses, coeffs, generators)

    mp.setattr(oavi, "collect_degree", collect)


def svm_state_unchanged(mp):
    """FISTA returns its starting point."""
    import torch

    import repro_torch.core.svm as psvm

    def fista(X, Y, lam, step, max_iter, tol):
        return (X.new_zeros((X.shape[1], Y.shape[1])), X.new_zeros((Y.shape[1],)),
                torch.tensor(max_iter))

    mp.setattr(psvm, "_fista", fista)


def svm_half_batch(mp):
    """FISTA's gradient is the mean over the first half of the rows."""
    import repro_torch.core.svm as psvm

    inner = psvm._squared_hinge_grad
    mp.setattr(psvm, "_squared_hinge_grad",
               lambda W, b, X, Y: inner(W, b, X[: X.shape[0] // 2], Y[: Y.shape[0] // 2]))


def label_altered(mp):
    """The test row the head is surest of answers the other class."""
    import repro_torch.core.svm as psvm

    inner = psvm.LinearSVM.predict

    def predict(self, X):
        out = inner(self, X).copy()
        scores = np.sort(self.decision_function(X), axis=1)
        i = int(np.argmax(scores[:, -1] - scores[:, -2]))
        out[i] = self.classes_[0] if out[i] != self.classes_[0] else self.classes_[1]
        return out

    mp.setattr(psvm.LinearSVM, "predict", predict)


GENERATOR_FAULTS = (ihb_state_unchanged, gram_half_batch, coefficient_altered,
                    decision_flipped)
SVM_FAULTS = (svm_state_unchanged, svm_half_batch, label_altered)
BY_NAME = {f.__name__: f for f in GENERATOR_FAULTS + SVM_FAULTS}
