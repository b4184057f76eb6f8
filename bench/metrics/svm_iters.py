"""FISTA iterations of the SVM head a fit (``core/svm.py``),
``clf.stats["svm"]["iters"]``: a count of work, mean over the window's fits.
Classifier cells only.

Unit ``iters``; moves ``fit_s``."""

def read(run):
    return run.mean("svm_iters")
