"""The host's launching of a FISTA step (``core/svm.py``): the ``svm/fista_block``
spans (each the launching of 32 masked steps, the stop tests' waits left out)
over the fit's ``svm_iters``, in microseconds, mean over the traced fits.
Traced runs of a program that records the span only.

Unit ``us``; moves ``fit_s``."""

from ..harness import spans


def read(run):
    return spans.per_step_us(run, "svm/fista_block")
