"""The SVM head's seconds a fit (``core/svm.py`` ``LinearSVM.fit``):
``clf.stats["time_svm"]``, host clock to the host copy of ``W``, mean
over the window's fits.  Classifier cells only.

Unit ``s``; moves ``fit_s``."""

def read(run):
    return run.mean("time_svm")
